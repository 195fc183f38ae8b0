"""Sequence classifier on top of the encoder stack.

Used for the neural marketplace "APIs" and the DistilBERT-analogue
generation scorer (``repro/models/classifier.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.layers import apply_norm
from repro_torch.models.transformer import (_apply_stack, _embed_inputs,
                                            _Init, _init_params)


def encoder_config(name: str, n_layers: int = 4, d_model: int = 128,
                   n_heads: int = 4, d_ff: int = 256, vocab: int = 512,
                   max_seq: int = 256) -> ModelConfig:
    return ModelConfig(
        name=name, arch_type="dense", n_layers=n_layers, d_model=d_model,
        n_heads=n_heads, n_kv_heads=n_heads, head_dim=d_model // n_heads,
        d_ff=d_ff, vocab=vocab,
        period=(LayerSpec("attn", "dense"),), n_periods=n_layers,
        pos="abs", causal=False, ffn_act="gelu", norm="layernorm",
        max_seq=max_seq, dtype="float32",
    )


def init_classifier(cfg: ModelConfig, n_classes: int, *, seed: int = 0,
                    device="cuda"):
    """Seeded encoder params plus a (d, n_classes) linear head."""
    init = _Init(seed, resolve_device(device))
    params = _init_params(init, cfg)
    params["head"] = {"w": init.normal(cfg.d_model, n_classes),
                      "b": init.const(0.0, n_classes)}
    return params


def params_device(params) -> torch.device:
    return params["embed"]["tok"].device


def as_tokens(tokens, device: torch.device):
    """A (B, L) token batch (numpy or tensor) as an int64 tensor on
    ``device``."""
    if isinstance(tokens, np.ndarray):
        tokens = torch.from_numpy(np.ascontiguousarray(tokens))
    return tokens.to(device=device, dtype=torch.int64)


def encode(params, tokens, cfg: ModelConfig):
    """tokens (B, L) -> final-normed hidden states (B, L, d)."""
    toks = as_tokens(tokens, params_device(params))
    x, _ = _apply_stack(params, _embed_inputs(params, toks, cfg), cfg=cfg)
    return apply_norm(params["final_norm"], x, cfg)


def classifier_logits(params, tokens, cfg: ModelConfig):
    """tokens: (B, L) -> class logits (B, C). Pools the CLS position."""
    h = encode(params, tokens, cfg)[:, 0]
    return h @ params["head"]["w"] + params["head"]["b"]


def classifier_score(params, tokens, cfg: ModelConfig):
    """Regression head in [0,1] (the generation scorer g)."""
    return torch.sigmoid(classifier_logits(params, tokens, cfg)[:, 0])
