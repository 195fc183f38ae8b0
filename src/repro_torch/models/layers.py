"""Common layers: layernorm, the gelu MLP, token embedding.

Params are plain dicts of tensors with the JAX package's shapes
(``repro/models/layers.py``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

Params = dict


def apply_norm(p: Params, x, cfg: ModelConfig, eps: float = 1e-6):
    """LayerNorm over the last axis in fp32 (eps 1e-6, as the reference)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return y.to(x.dtype)


def apply_dense(p: Params, x):
    return x @ p["w"]


def apply_mlp(p: Params, x, cfg: ModelConfig):
    """up -> gelu -> down. The reference uses ``jax.nn.gelu``, whose
    default is the tanh approximation."""
    h = F.gelu(apply_dense(p["up"], x), approximate="tanh")
    return apply_dense(p["down"], h)


def embed_tokens(p: Params, tokens, cfg: ModelConfig):
    return F.embedding(tokens, p["tok"])
