"""GQA flash attention: the CUDA kernel's wrapper ``mha`` and its plain
PyTorch version ``mha_reference``.

``mha`` runs the plain version only for tensors on the CPU. For CUDA
tensors it launches ``flash_attention.cu`` or raises; it never falls
back. ``mha.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels._grad import refuse_grad

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256          # the CUDA kernel's limit


def _check(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"q/k/v must be (B, S, H, hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, hd = q.shape
    if k.shape[:2] != (b, s) or k.shape[3] != hd or v.shape != k.shape:
        raise ValueError(f"k/v must be (B, S, KVH, hd) = ({b}, {s}, KVH, "
                         f"{hd}), got {tuple(k.shape)} and {tuple(v.shape)}")
    if k.shape[2] == 0 or h % k.shape[2]:
        raise ValueError(f"{h} query heads are not a multiple of "
                         f"{k.shape[2]} KV heads")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"q/k/v must share a dtype in {list(_DTYPES)}, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q/k/v must be on one device")


def mha_reference(q, k, v, *, causal: bool = True, window: int = 0):
    """Plain version: masked full softmax in fp32 over (B, S, H, hd).

    Same masks as the kernel; a row with no visible key gives 0 (the
    kernel's ``0 / max(l, 1e-30)``)."""
    _check(q, k, v)
    b, s, h, hd = q.shape
    g = h // k.shape[2]
    qf = q.float().transpose(1, 2)                          # (B, H, S, hd)
    kf = k.float().transpose(1, 2).repeat_interleave(g, dim=1)
    vf = v.float().transpose(1, 2).repeat_interleave(g, dim=1)
    logits = (qf @ kf.transpose(-1, -2)) * (1.0 / math.sqrt(hd))
    pos = torch.arange(s, device=q.device)
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos[None, :] <= pos[:, None]
    if window > 0:
        mask &= pos[None, :] > pos[:, None] - window
    logits = logits.masked_fill(~mask, float("-inf"))
    m = logits.amax(-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(logits - m)
    o = (p @ vf) / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return o.transpose(1, 2).contiguous().to(q.dtype)


_FN = None


def _kernel():
    global _FN
    if _FN is None:
        from repro_torch.kernels._build import library
        fn = library("flash_attention").repro_flash_attention
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32, i32,
                       ctypes.c_float, i32, i32, i32, vp]
        fn.restype = i32
        _FN = fn
    return _FN


def mha(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, S, H, hd); k/v: (B, S, KVH, hd). Returns (B, S, H, hd).

    Any S (the kernel masks the ragged tail); GQA maps query head h to
    KV head h // (H // KVH). CUDA tensors must be contiguous, float32 or
    bfloat16, with hd <= 256."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return mha_reference(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"mha runs on cuda or cpu tensors, got {q.device}")
    refuse_grad("mha", q, k, v)
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("mha's CUDA kernel needs contiguous q/k/v")
    b, s, h, hd = q.shape
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd} > {MAX_HEAD_DIM}, the kernel's limit")
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    rc = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                   b, s, h, k.shape[2], hd, 1.0 / math.sqrt(hd), int(causal),
                   int(window), _DTYPES[q.dtype],
                   torch.cuda.current_stream(q.device).cuda_stream)
    if rc:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {rc}")
    mha.launches += 1
    return o


mha.launches = 0
