"""Weights from the JAX package into the port, and between devices.

``params_from_numpy`` takes ``repro`` params as nested dicts/lists of
numpy arrays (e.g. ``jax.tree.map(np.asarray, params)``) and returns the
port's layout: the scanned ``period`` stack (leading axis ``n_periods``)
is unstacked into one dict per layer, after the prefix blocks and before
the suffix blocks, in ``cfg.layers`` order. Leaves are read as fp32
masters (the reference keeps fp32 params and casts at each use) and
handed out in the compute dtype by ``transformer.cast_params``, which
gives the same bf16 values the reference's casts do. Whatever leaves the
tree has (gated MLPs' ``gate``, bias-less norms, no ``embed.pos`` or
``embed.unembed``; an MoE layer's router, stacked experts and ``sh_*``;
a Mamba layer's projections, convs, ``A_log``, ``D``, ``dt_bias`` and
norm) are carried over as they are. It imports no jax.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.transformer import cast_params


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from ((f"{k}/{p}", a) for p, a in _leaves(v))
    else:
        yield "", tree


def params_from_numpy(tree: dict, cfg: ModelConfig, *, device="cuda") -> dict:
    dev = resolve_device(device)
    expected = len(cfg.prefix) + len(cfg.suffix) + cfg.n_periods * len(cfg.period)
    layers = list(tree.get("prefix", []))
    if cfg.n_periods:
        period = tree["period"]
        stacked = {len(a) for _, a in _leaves(period)}
        if stacked != {cfg.n_periods}:
            raise ValueError(f"{cfg.name}: period stack holds {stacked} "
                             f"layers, config expects {cfg.n_periods}")
        for i in range(cfg.n_periods):
            for j in range(len(cfg.period)):
                layers.append(_tree_map(lambda a, i=i: a[i], period[f"sub{j}"]))
    layers += list(tree.get("suffix", []))
    if len(layers) != expected:
        raise ValueError(f"{cfg.name}: params hold {len(layers)} layers, "
                         f"config expects {expected}")
    out = {k: v for k, v in tree.items()
           if k not in ("prefix", "period", "suffix")}
    out["layers"] = layers
    master = _tree_map(lambda a: torch.from_numpy(
        np.array(a, dtype=np.float32)).to(dev), out)
    return cast_params(master, cfg)


def params_to(params: dict, device) -> dict:
    """A copy of ``params`` on ``device``."""
    dev = resolve_device(device)
    return _tree_map(lambda t: t.to(dev), params)
