"""GQA attention mixer, full-sequence ("train") mode.

Every call goes through the flash-attention kernel's wrapper ``mha``,
at any sequence length: the CUDA kernel masks the ragged tail, so unlike
the reference (``repro/models/attention.py``, which sends S % 128 != 0
to ``_chunked_attention``) there is no length gate and no kernel switch.
Decode, the sliding ring cache, rope/mrope and MLA are later slices.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import mha
from repro_torch.models.layers import Params


def apply_attn(p: Params, x, *, cfg: ModelConfig, sliding: bool):
    """x: (B, S, d) -> (B, S, d). Weights keep the reference layouts:
    wq (d, H, hd), wk/wv (d, KVH, hd), wo (H, hd, d)."""
    b, s, d = x.shape
    q = (x @ p["wq"].reshape(d, -1)).view(b, s, cfg.n_heads, cfg.head_dim)
    k = (x @ p["wk"].reshape(d, -1)).view(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = (x @ p["wv"].reshape(d, -1)).view(b, s, cfg.n_kv_heads, cfg.head_dim)
    window = cfg.window if sliding else 0
    o = mha(q, k, v, causal=cfg.causal, window=window)
    return o.reshape(b, s, cfg.q_dim) @ p["wo"].reshape(cfg.q_dim, d)
