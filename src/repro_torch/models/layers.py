"""Common layers: norms, MLPs, embeddings, RoPE (``repro/models/layers.py``).

Params are plain dicts of tensors with the JAX package's shapes. The
reference keeps fp32 masters and casts each weight to the compute dtype
at every use (``cast``); the port casts once, when the params are made
(``transformer.cast_params``), so ``cast`` here is a no-op on them and
the values are the same bf16 numbers. Products take bf16 operands,
accumulate in fp32 and round the result to bf16, as ``einsum(...,
preferred_element_type=float32).astype(x.dtype)`` does, except the
logits, which stay fp32 (``unembed``).
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

Params = dict

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def cast(x, cfg: ModelConfig):
    return x.to(compute_dtype(cfg))


def apply_norm(p: Params, x, cfg: ModelConfig, eps: float = 1e-6):
    """LayerNorm (when the config says so or ``p`` has a bias) or RMSNorm
    over the last axis, in fp32, eps 1e-6. RMSNorm's scale multiplies as
    it is (no ``1 +``), as in the reference."""
    if cfg.norm != "layernorm" and "bias" not in p:
        return rmsnorm(x, p["scale"], eps)
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * p["scale"]
    if "bias" in p:
        y = y + p["bias"]
    return y.to(x.dtype)


def rmsnorm(x, scale, eps: float = 1e-6):
    """RMSNorm over the last axis in fp32, returned in x's dtype (the
    Mamba mixer's gated norm calls it on its own)."""
    xf = x.float()
    ms = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale).to(x.dtype)


def apply_dense(p: Params, x, cfg: ModelConfig):
    return x @ cast(p["w"], cfg)


def _act(name: str, x):
    """``repro``'s ``_act``: silu for swiglu, otherwise ``jax.nn.gelu``,
    whose default is the tanh approximation (so geglu is tanh-gelu)."""
    if name == "swiglu":
        return F.silu(x)
    return F.gelu(x, approximate="tanh")


def apply_mlp(p: Params, x, cfg: ModelConfig):
    """up -> act -> down, or act(gate) * up -> down for gated MLPs."""
    up = apply_dense(p["up"], x, cfg)
    if "gate" in p:
        h = _act(cfg.ffn_act, apply_dense(p["gate"], x, cfg)) * up
    else:
        h = _act(cfg.ffn_act, up)
    return apply_dense(p["down"], h, cfg)


def embed_tokens(p: Params, tokens, cfg: ModelConfig):
    return cast(F.embedding(tokens, p["tok"]), cfg)


def unembed(p: Params, x, cfg: ModelConfig):
    """Logits in fp32: (..., d) -> (..., V). The table (``tok`` when tied,
    else ``unembed``) holds compute-dtype values stored as fp32
    (``transformer.cast_params``), so an fp32 product of the upcast
    activations gives the reference's bf16 x bf16 -> fp32 einsum."""
    if cfg.tie_embeddings:
        return x.float() @ p["tok"].float().T
    return x.float() @ p["unembed"].float()


def rope_freqs(head_dim: int, theta: float):
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32) / half))


@functools.lru_cache(maxsize=64)
def _rope_freqs_on(head_dim: int, theta: float, device: torch.device):
    """``rope_freqs`` computed on the CPU once and kept on ``device``, so
    every device sees the same values and a decode step copies nothing."""
    return rope_freqs(head_dim, theta).to(device)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: broadcastable to (..., S).

    Half-split rotation (not interleaved), angles and products in fp32."""
    hd = x.shape[-1]
    inv = _rope_freqs_on(hd, theta, x.device)              # (hd/2,)
    ang = positions[..., None].float() * inv               # (..., S, hd/2)
    ang = ang[..., None, :]                                # (..., S, 1, hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
