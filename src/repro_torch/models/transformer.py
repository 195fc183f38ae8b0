"""Encoder stack: seeded params, token embedding, blocks, the layer loop.

Mirrors ``repro/models/transformer.py`` in full-sequence ("train") mode.
The reference stacks the ``period`` layers on a leading axis and runs
them with ``lax.scan``; here ``params["layers"]`` is a list with one
dict per layer, in ``cfg.layers`` order, and the scan is a Python loop.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.attention import apply_attn
from repro_torch.models.layers import apply_mlp, apply_norm, embed_tokens

_INIT_SCALE = 0.02


class _Init:
    """Seeded draws. The generator lives on the CPU, so a seed gives the
    same weights whatever device they are copied to."""

    def __init__(self, seed: int, device: torch.device):
        self.gen = torch.Generator().manual_seed(seed)
        self.device = device

    def normal(self, *shape, scale: float = _INIT_SCALE):
        w = scale * torch.randn(shape, generator=self.gen)
        return w.to(self.device)

    def const(self, value: float, *shape):
        return torch.full(shape, value, device=self.device)

    def norm(self, d: int):
        return {"scale": self.const(1.0, d), "bias": self.const(0.0, d)}


def _init_block(init: _Init, cfg: ModelConfig, spec: LayerSpec):
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {"norm1": init.norm(d),
         "mixer": {"wq": init.normal(d, h, hd), "wk": init.normal(d, kvh, hd),
                   "wv": init.normal(d, kvh, hd), "wo": init.normal(h, hd, d)}}
    if spec.ffn == "dense":
        p["norm2"] = init.norm(d)
        p["ffn"] = {"up": {"w": init.normal(d, cfg.d_ff)},
                    "down": {"w": init.normal(cfg.d_ff, d)}}
    return p


def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda"):
    """Random params with the reference's shapes and scales
    (``transformer.py::init_params``: N(0, 0.02) weights, unit norm
    scales, zero norm biases), drawn from a seeded ``torch.Generator``.
    JAX's threefry and torch's generator differ, so the same seed gives
    other numbers than the reference: parity tests convert JAX params
    instead (``repro_torch.convert``)."""
    return _init_params(_Init(seed, resolve_device(device)), cfg)


def _init_params(init: _Init, cfg: ModelConfig):
    d = cfg.d_model
    embed = {"tok": init.normal(cfg.vocab, d),
             "pos": init.normal(min(cfg.max_seq, 65_536), d)}
    if not cfg.tie_embeddings:
        embed["unembed"] = init.normal(d, cfg.vocab)
    return {"embed": embed, "final_norm": init.norm(d),
            "layers": [_init_block(init, cfg, s) for s in cfg.layers]}


def apply_block(p, x, *, cfg: ModelConfig, spec: LayerSpec):
    h = apply_norm(p["norm1"], x, cfg)
    x = x + apply_attn(p["mixer"], h, cfg=cfg,
                       sliding=spec.mixer == "attn_sliding")
    if spec.ffn != "none":
        h = apply_norm(p["norm2"], x, cfg)
        x = x + apply_mlp(p["ffn"], h, cfg)
    return x


def _apply_stack(params, x, *, cfg: ModelConfig):
    for p, spec in zip(params["layers"], cfg.layers):
        x = apply_block(p, x, cfg=cfg, spec=spec)
    return x


def _embed_inputs(params, tokens, cfg: ModelConfig):
    """Token embeddings (B, S, d). As in the reference, no position
    embedding is added on the token path: ``repro``'s ``_embed_inputs``
    adds ``embed.pos`` only to precomputed input embeddings
    (transformer.py:276), and parity follows it."""
    return embed_tokens(params["embed"], tokens, cfg)
