"""GQA attention mixer (``repro/models/attention.py``): full-sequence
("train"), "prefill" (builds the KV cache) and "decode" (one token
against it).

Every full-sequence attention goes through the flash-attention kernel's
wrapper ``mha``, and every decode attention through the decode kernel's
wrapper ``gqa_decode``, at any length: both CUDA kernels mask the ragged
tail, so unlike the reference (which sends S % 128 != 0 to plain jnp and
sliding layers always to ``_decode_attention``) there is no length gate
and no kernel switch.

KV caches, one dict ``{"k", "v"}`` of (B, S_c, KVH, hd) per layer:
  * full attention: S_c = the cache length; position p lives at slot p
    and decode attends to slots < pos + 1;
  * sliding window: a ring of S_c = min(window, cache length) slots;
    position p lives at slot p % S_c.

Ring caches go through the same decode kernel. The reference masks a
ring with ``slot_pos >= 0 & slot_pos <= pos`` (``ring_slot_positions``).
For S_c <= window slots that mask marks exactly the slots i <
min(pos + 1, S_c): while pos < S_c, slot i holds position i, so the
valid slots are 0..pos; once the ring has wrapped, every slot holds one
of the last S_c positions, all <= pos. The valid slots are therefore a
prefix of the ring, and softmax does not depend on the order of its
keys, so ``gqa_decode(q, k, v, min(pos + 1, S_c))`` computes the
reference's function (``tests/test_torch_decode_attention.py`` holds
it against ``_decode_attention`` across wraps).

Decode updates the cache in place (the reference returns a new one):
a cache is created by ``prefill`` and handed to exactly one decode loop
(``serving.engine.PrefillFuture`` is consumed once), so nothing else
sees the old values. rope/mrope variants other than plain RoPE and MLA
are later slices.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention.ops import gqa_decode
from repro_torch.kernels.flash_attention.ops import mha
from repro_torch.models.layers import Params, apply_rope, cast, compute_dtype


def init_attn_cache(cfg: ModelConfig, sliding: bool, batch: int, seq: int,
                    dtype=None, device="cpu"):
    """Zeros KV cache for one attention layer: (B, seq, KVH, hd) K/V, or
    a ring of ``min(window, seq)`` slots for a sliding layer."""
    dtype = dtype or compute_dtype(cfg)
    s = min(cfg.window, seq) if sliding and cfg.window else seq
    shape = (batch, s, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def ring_slot_positions(pos: int, window: int):
    """Absolute position stored in each ring-buffer slot when the *current*
    write position is ``pos`` (i.e. ``pos`` tokens already written);
    negative = never written."""
    i = torch.arange(window)
    return pos - torch.remainder(pos - i, window)


def _project(x, w, cfg: ModelConfig, heads: int):
    b, s, d = x.shape
    return (x @ cast(w, cfg).reshape(d, -1)).view(b, s, heads, cfg.head_dim)


def apply_attn(p: Params, x, *, cfg: ModelConfig, sliding: bool,
               mode: str = "train", positions=None, cache=None,
               pos: int = 0, max_len: int = 0):
    """mode: 'train' | 'prefill' | 'decode'. x: (B, S, d) (S = 1 in
    decode). positions: rope positions broadcastable to (B, S). decode:
    ``pos`` is the count of tokens already cached. Weights keep the
    reference layouts: wq (d, H, hd), wk/wv (d, KVH, hd), wo (H, hd, d).
    Returns (y, new_cache); new_cache is None in train mode."""
    b, s, d = x.shape
    q = _project(x, p["wq"], cfg, cfg.n_heads)
    k = _project(x, p["wk"], cfg, cfg.n_kv_heads)
    v = _project(x, p["wv"], cfg, cfg.n_kv_heads)
    if cfg.pos == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    window = cfg.window if sliding else 0

    new_cache = None
    if mode in ("train", "prefill"):
        o = mha(q, k, v, causal=cfg.causal, window=window)
        if mode == "prefill":
            new_cache = _prefill_cache(k, v, window, max_len)
    elif mode == "decode":
        ck, cv = cache["k"], cache["v"]
        s_c = ck.shape[1]
        if window and s_c <= window:          # ring: slot pos % s_c
            slot, length = pos % s_c, min(pos + 1, s_c)
        else:
            slot, length = pos, pos + 1
        ck[:, slot] = k[:, 0]
        cv[:, slot] = v[:, 0]
        o = gqa_decode(q, ck, cv, length)
        new_cache = cache
    else:
        raise ValueError(f"unknown mode {mode!r}")
    y = o.reshape(b, s, cfg.q_dim) @ cast(p["wo"], cfg).reshape(cfg.q_dim, d)
    return y, new_cache


def _prefill_cache(k, v, window: int, max_len: int):
    """The decode cache prefill leaves: a ring of min(window, max_len)
    slots holding the last positions at slot p % len for a sliding layer,
    else K/V zero-padded to ``max_len``."""
    b, s = k.shape[:2]
    if window:
        cache_len = min(window, max_len) if max_len else min(window, s)
        if s >= cache_len:
            last = torch.arange(s - cache_len, s, device=k.device)
            idx = last[torch.argsort(torch.remainder(last, cache_len))]
            return {"k": k[:, idx].contiguous(), "v": v[:, idx].contiguous()}
        grow = cache_len - s
    else:
        grow = max(0, max_len - s) if max_len else 0
    pad = (0, 0, 0, 0, 0, grow)                # (hd, KVH, S) from the last
    return {"k": F.pad(k, pad), "v": F.pad(v, pad)}
