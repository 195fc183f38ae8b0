"""Model assembly (``repro/models/transformer.py``): seeded params, token
embedding, blocks, the layer loop, prefill and decode.

The reference stacks the ``period`` layers on a leading axis and runs
them with ``lax.scan``; here ``params["layers"]`` is a list with one
dict per layer, in ``cfg.layers`` order, the scan is a Python loop, and
a decode cache is a list with one dict per layer: ``{"k", "v"}`` for
attention (``models/attention.py``), ``{"conv_x", "conv_bc", "ssm"}``
for Mamba (``models/ssm.py``). A block's mixer is attention or Mamba and
its FFN dense, MoE (``models/moe.py``) or none, as ``LayerSpec`` says.

Public API:
  init_params(cfg, seed=, device=)       -> params
  cast_params(params, cfg)               -> params in the compute dtype
  init_cache(cfg, batch, seq[, dtype])   -> decode cache (list per layer)
  prefill(params, batch, cfg, max_len=, last_index=) -> (logits, cache)
  decode_step(params, cache, tokens, pos, cfg)      -> (logits, cache)
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import moe, ssm
from repro_torch.models.attention import apply_attn, init_attn_cache
from repro_torch.models.layers import (apply_mlp, apply_norm, compute_dtype,
                                       embed_tokens, unembed)

_INIT_SCALE = 0.02


class _Init:
    """Seeded draws. The generator lives on the CPU, so a seed gives the
    same weights whatever device they are copied to."""

    def __init__(self, seed: int, device: torch.device):
        self.gen = torch.Generator().manual_seed(seed)
        self.device = device

    def normal(self, *shape, scale: float = _INIT_SCALE):
        w = torch.randn(shape, generator=self.gen).mul_(scale)
        return w.to(self.device)

    def const(self, value: float, *shape):
        return torch.full(shape, value, device=self.device)

    def norm(self, cfg: ModelConfig):
        p = {"scale": self.const(1.0, cfg.d_model)}
        if cfg.norm == "layernorm":
            p["bias"] = self.const(0.0, cfg.d_model)
        return p


def _init_block(init: _Init, cfg: ModelConfig, spec: LayerSpec):
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {"norm1": init.norm(cfg)}
    if spec.mixer == "mamba":
        p["mixer"] = ssm.init_mamba(init, cfg)
    else:
        p["mixer"] = {"wq": init.normal(d, h, hd),
                      "wk": init.normal(d, kvh, hd),
                      "wv": init.normal(d, kvh, hd),
                      "wo": init.normal(h, hd, d)}
    if spec.ffn != "none":
        p["norm2"] = init.norm(cfg)
    if spec.ffn == "moe":
        p["ffn"] = moe.init_moe(init, cfg)
    elif spec.ffn == "dense":
        p["ffn"] = {"up": {"w": init.normal(d, cfg.d_ff)},
                    "down": {"w": init.normal(cfg.d_ff, d)}}
        if cfg.ffn_act in ("swiglu", "geglu"):
            p["ffn"]["gate"] = {"w": init.normal(d, cfg.d_ff)}
    return p


def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda"):
    """Random params with the reference's shapes and scales
    (``transformer.py::init_params``: N(0, 0.02) weights, unit norm
    scales, zero norm biases), drawn in fp32 from a seeded
    ``torch.Generator`` and cast by ``cast_params``. JAX's threefry and
    torch's generator differ, so the same seed gives other numbers than
    the reference: parity tests convert JAX params instead
    (``repro_torch.convert``)."""
    return cast_params(_init_params(_Init(seed, resolve_device(device)), cfg),
                       cfg)


def _init_params(init: _Init, cfg: ModelConfig):
    d = cfg.d_model
    embed = {"tok": init.normal(cfg.vocab, d)}
    if cfg.pos == "abs":
        embed["pos"] = init.normal(min(cfg.max_seq, 65_536), d)
    if not cfg.tie_embeddings:
        embed["unembed"] = init.normal(d, cfg.vocab)
    return {"embed": embed, "final_norm": init.norm(cfg),
            "layers": [_init_block(init, cfg, s) for s in cfg.layers]}


def cast_params(params, cfg: ModelConfig):
    """fp32 master params -> the compute copy: every leaf of 2 or more
    dims in ``cfg.dtype``, the 1-d leaves (norm scales and biases, and
    Mamba's ``A_log``, ``D``, ``dt_bias``, conv biases and gated norm) in
    fp32, as the reference's ``_cast_params`` keeps them and its ``cast``
    at each use gives them. The logits table
    (``embed.tok`` when tied, else ``embed.unembed``) is rounded to
    ``cfg.dtype`` but stored in fp32, so the unembedding is an fp32
    product of compute-dtype values, like the reference's einsum with
    ``preferred_element_type=float32``, and the logits keep 24 bits. A
    no-op for float32 configs."""
    dt = compute_dtype(cfg)
    if dt == torch.float32:
        return params
    table = ("embed", "tok" if cfg.tie_embeddings else "unembed")

    def walk(tree, path=()):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, path) for v in tree]
        if tree.ndim < 2 or tree.dtype != torch.float32:
            return tree
        if path == table:
            return tree.to(dt).float()
        return tree.to(dt)

    return walk(params)


def init_block_cache(cfg: ModelConfig, spec: LayerSpec, batch: int, seq: int,
                     dtype=None, device="cpu"):
    if spec.mixer == "mamba":
        return ssm.init_mamba_cache(cfg, batch, dtype, device)
    return init_attn_cache(cfg, spec.mixer == "attn_sliding", batch, seq,
                           dtype, device)


def init_cache(cfg: ModelConfig, batch: int, seq: int, dtype=None,
               device="cpu"):
    """Zeros decode cache: one dict per layer, in order."""
    return [init_block_cache(cfg, s, batch, seq, dtype, device)
            for s in cfg.layers]


def apply_block(p, x, *, cfg: ModelConfig, spec: LayerSpec,
                mode: str = "train", positions=None, cache=None, pos: int = 0,
                max_len: int = 0):
    """One block (mixer + FFN). Returns (x, new_cache); an MoE FFN's
    load-balance loss (``moe.apply_moe``) is a training term and is not
    kept here."""
    h = apply_norm(p["norm1"], x, cfg)
    if spec.mixer == "mamba":
        y, new_cache = ssm.apply_mamba(p["mixer"], h, cfg=cfg, mode=mode,
                                       cache=cache)
    else:
        y, new_cache = apply_attn(p["mixer"], h, cfg=cfg,
                                  sliding=spec.mixer == "attn_sliding",
                                  mode=mode, positions=positions, cache=cache,
                                  pos=pos, max_len=max_len)
    x = x + y
    if spec.ffn != "none":
        h = apply_norm(p["norm2"], x, cfg)
        if spec.ffn == "moe":
            y, _ = moe.apply_moe(p["ffn"], h, cfg=cfg)
        else:
            y = apply_mlp(p["ffn"], h, cfg)
        x = x + y
    return x, new_cache


def _apply_stack(params, x, *, cfg: ModelConfig, mode: str = "train",
                 positions=None, cache=None, pos: int = 0, max_len: int = 0):
    """The layer loop. Returns (x, new_cache): a list per layer in
    "prefill" and "decode", None in "train"."""
    new_cache = [] if mode != "train" else None
    for i, (p, spec) in enumerate(zip(params["layers"], cfg.layers)):
        x, nc = apply_block(p, x, cfg=cfg, spec=spec, mode=mode,
                            positions=positions,
                            cache=None if cache is None else cache[i],
                            pos=pos, max_len=max_len)
        if new_cache is not None:
            new_cache.append(nc)
    return x, new_cache


def _embed_inputs(params, tokens, cfg: ModelConfig):
    """Token embeddings (B, S, d) in the compute dtype. As in the
    reference, no position embedding is added on the token path:
    ``repro``'s ``_embed_inputs`` adds ``embed.pos`` only to precomputed
    input embeddings (transformer.py:276), and parity follows it."""
    return embed_tokens(params["embed"], tokens, cfg)


def _tokens(params, tokens):
    dev = params["embed"]["tok"].device
    if not torch.is_tensor(tokens):
        tokens = torch.from_numpy(np.ascontiguousarray(tokens))
    return tokens.to(device=dev, dtype=torch.int64)


def prefill(params, batch, cfg: ModelConfig, max_len: int = 0,
            last_index: int | None = None):
    """Full-sequence forward building the decode cache. ``batch``:
    {"tokens": (B, S)}. ``max_len``: decode-cache length (>= prompt
    length; default the prompt length). ``last_index``: position whose
    logits to return (default the last) — right-padded prompts read their
    true last token. Returns (fp32 logits (B, 1, V), cache). Encoder-only
    configs run through ``models.classifier`` instead."""
    if not cfg.decode_supported:
        raise ValueError(f"{cfg.name}: prefill builds a decode cache; "
                         f"encoder-only archs have none")
    tokens = _tokens(params, batch["tokens"])
    x = _embed_inputs(params, tokens, cfg)
    s = tokens.shape[1]
    positions = (torch.arange(s, device=x.device) if cfg.pos == "rope"
                 else None)
    x, cache = _apply_stack(params, x, cfg=cfg, mode="prefill",
                            positions=positions, max_len=max_len or s)
    i = s - 1 if last_index is None else int(last_index)
    h = apply_norm(params["final_norm"], x[:, i:i + 1], cfg)
    return unembed(params["embed"], h, cfg), cache


def decode_step(params, cache, tokens, pos: int, cfg: ModelConfig):
    """One decode step: tokens (B, 1), ``pos`` = fill level of the cache
    (a host int). Updates ``cache`` in place and returns (fp32 logits
    (B, 1, V), cache)."""
    if not cfg.decode_supported:
        raise ValueError(f"{cfg.name}: decode not supported for "
                         f"encoder-only archs")
    tokens = _tokens(params, tokens)
    x = _embed_inputs(params, tokens, cfg)
    positions = (torch.full((1,), pos, device=x.device)
                 if cfg.pos == "rope" else None)
    x, cache = _apply_stack(params, x, cfg=cfg, mode="decode",
                            positions=positions, cache=cache, pos=pos)
    h = apply_norm(params["final_norm"], x, cfg)
    return unembed(params["embed"], h, cfg), cache
