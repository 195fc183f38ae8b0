"""GQA decode attention: the CUDA kernel's wrapper ``gqa_decode`` and its
plain PyTorch version ``decode_reference``.

``gqa_decode`` runs the plain version only for tensors on the CPU. For
CUDA tensors it launches ``decode_attention.cu`` or raises; it never
falls back. ``gqa_decode.launches`` counts the kernel launches: one per
call when the keys fit one split, else two (``decode_partial`` over the
splits, then ``decode_combine``).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels._grad import refuse_grad

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256          # the CUDA kernel's limit
#: keys per split at least; the split count fills ~2 blocks per SM
_MIN_CHUNK = 64
_TARGET_BLOCKS = 264        # 2 x the H100's 132 SMs
_ROWS = 4                   # query rows per block (GB in the source)


def _check(q, k, v, length):
    if q.ndim != 4 or q.shape[1] != 1 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"q must be (B, 1, H, hd) and k/v (B, S, KVH, hd), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, _, h, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"k/v must be ({b}, S, KVH, {hd}), got "
                         f"{tuple(k.shape)}")
    if k.shape[2] == 0 or h % k.shape[2]:
        raise ValueError(f"{h} query heads are not a multiple of "
                         f"{k.shape[2]} KV heads")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"q/k/v must share a dtype in {list(_DTYPES)}, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q/k/v must be on one device")
    if not 1 <= length <= k.shape[1]:
        raise ValueError(f"length {length} outside [1, S={k.shape[1]}]")


def decode_reference(q, k, v, length: int):
    """Plain version: softmax over the keys at positions < ``length`` in
    fp32, scale 1/sqrt(hd). q (B, 1, H, hd), k/v (B, S, KVH, hd) ->
    (B, 1, H, hd) in q's dtype."""
    length = int(length)
    _check(q, k, v, length)
    b, _, h, hd = q.shape
    kvh = k.shape[2]
    qg = q.float().reshape(b, kvh, h // kvh, hd)
    kf = k[:, :length].float()
    vf = v[:, :length].float()
    logits = torch.einsum("bkgd,bskd->bkgs", qg, kf) * (1.0 / math.sqrt(hd))
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, vf)
    return o.reshape(b, 1, h, hd).to(q.dtype)


_FN = None


def _kernel():
    global _FN
    if _FN is None:
        from repro_torch.kernels._build import library
        fn = library("decode_attention").repro_decode_attention
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, i32,
                       i32, ctypes.c_float, i32, vp]
        fn.restype = i32
        _FN = fn
    return _FN


def split_plan(b: int, kvh: int, g: int, length: int) -> tuple[int, int]:
    """(n_split, chunk): the keys [0, length) cut into ``n_split`` chunks
    of ``chunk`` keys (the last may be shorter), enough to give the card
    about ``_TARGET_BLOCKS`` blocks, with at least ``_MIN_CHUNK`` keys each."""
    blocks = b * kvh * -(-g // _ROWS)
    want = max(1, -(-_TARGET_BLOCKS // blocks))
    chunk = max(_MIN_CHUNK, -(-length // want))
    chunk = -(-chunk // 32) * 32
    return -(-length // chunk), chunk


def gqa_decode(q, k, v, length: int):
    """q: (B, 1, H, hd) one query token; k/v: (B, S, KVH, hd) the cache.
    Attends to the keys at positions < ``length`` (1 <= length <= S; any
    S, no block multiple). Query head h reads KV head h // (H // KVH).
    Returns (B, 1, H, hd). CUDA tensors must be contiguous, float32 or
    bfloat16, with hd <= 256."""
    length = int(length)
    _check(q, k, v, length)
    if q.device.type == "cpu":
        return decode_reference(q, k, v, length)
    if q.device.type != "cuda":
        raise ValueError(f"gqa_decode runs on cuda or cpu tensors, got "
                         f"{q.device}")
    refuse_grad("gqa_decode", q, k, v)
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("gqa_decode's CUDA kernel needs contiguous q/k/v")
    b, _, h, hd = q.shape
    s, kvh = k.shape[1], k.shape[2]
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd} > {MAX_HEAD_DIM}, the kernel's limit")
    g = h // kvh
    n_split, chunk = split_plan(b, kvh, g, length)
    o = torch.empty_like(q)
    # per-split partial results: unnormalised sums (n_split, B*H, hd) and
    # their running max and denominator (n_split, B*H, 2), fp32
    part_o = torch.empty((n_split, b * h, hd), dtype=torch.float32,
                         device=q.device) if n_split > 1 else o
    part_ml = torch.empty((n_split, b * h, 2), dtype=torch.float32,
                          device=q.device) if n_split > 1 else o
    rc = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                   part_o.data_ptr(), part_ml.data_ptr(), b, s, h, kvh, hd,
                   length, chunk, 1.0 / math.sqrt(hd), _DTYPES[q.dtype],
                   torch.cuda.current_stream(q.device).cuda_stream)
    if rc:
        raise RuntimeError(f"decode_attention launch failed: CUDA error {rc}")
    gqa_decode.launches += 1 if n_split == 1 else 2
    return o


gqa_decode.launches = 0
