"""Pending-set compaction for the cascade: the CUDA kernel's wrapper
``compact`` and its plain PyTorch version ``compact_reference``.

``compact`` runs the plain version only for tensors on the CPU. For CUDA
tensors it launches ``cascade_compact.cu`` or raises; it never falls
back. ``compact.launches`` counts the kernels' launches: two per call
(``count_kept``, then ``scatter_kept``).
"""
from __future__ import annotations

import ctypes

import torch

_BLOCK = 1024               # rows per CUDA block (cascade_compact.cu)


def _check(idx, keep):
    if idx.ndim != 1 or idx.shape != keep.shape:
        raise ValueError(f"idx/keep must be matching 1-D vectors, got "
                         f"{tuple(idx.shape)} and {tuple(keep.shape)}")
    if idx.dtype != torch.int32 or keep.dtype != torch.bool:
        raise TypeError(f"idx must be int32 and keep bool, got {idx.dtype} "
                        f"and {keep.dtype}")
    if idx.device != keep.device:
        raise ValueError("idx and keep must be on one device")


def compact_reference(idx, keep, *, fill: int = -1):
    """Plain version: ``idx[keep]`` padded with ``fill`` to ``len(idx)``,
    and the count as a 0-d int32 tensor."""
    _check(idx, keep)
    kept = idx[keep]
    out = torch.full_like(idx, fill)
    out[:len(kept)] = kept
    return out, torch.tensor(len(kept), dtype=torch.int32, device=idx.device)


_FN = None


def _kernel():
    global _FN
    if _FN is None:
        from repro_torch.kernels._build import library
        fn = library("cascade_compact").repro_cascade_compact
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, i32, i32, vp]
        fn.restype = i32
        _FN = fn
    return _FN


def compact(idx, keep, *, fill: int = -1):
    """idx (n,) int32, keep (n,) bool -> (padded (n,) int32, count 0-d
    int32), both on idx's device. ``padded[:count]`` are the kept indices
    in original order; the tail is ``fill``. n = 0 launches nothing."""
    _check(idx, keep)
    if idx.device.type == "cpu":
        return compact_reference(idx, keep, fill=fill)
    if idx.device.type != "cuda":
        raise ValueError(f"compact runs on cuda or cpu tensors, got "
                         f"{idx.device}")
    if not (idx.is_contiguous() and keep.is_contiguous()):
        raise ValueError("compact's CUDA kernel needs contiguous idx/keep")
    n = idx.shape[0]
    if n == 0:
        return idx.clone(), torch.zeros((), dtype=torch.int32,
                                        device=idx.device)
    count = torch.empty((), dtype=torch.int32, device=idx.device)
    out = torch.empty_like(idx)
    scratch = torch.empty(-(-n // _BLOCK), dtype=torch.int32,
                          device=idx.device)
    rc = _kernel()(idx.data_ptr(), keep.data_ptr(), out.data_ptr(),
                   count.data_ptr(), scratch.data_ptr(), n, int(fill),
                   torch.cuda.current_stream(idx.device).cuda_stream)
    if rc:
        raise RuntimeError(f"cascade_compact launch failed: CUDA error {rc}")
    compact.launches += 2         # count_kept + scatter_kept
    return out, count


compact.launches = 0
