"""Grouped expert matmul: the CUDA kernel's wrapper ``gmm``, its plain
PyTorch version ``gmm_reference``, and ``expert_mlp``, the gated expert
FFN made of three ``gmm`` calls (``repro/kernels/moe_gmm/ops.py``).

``gmm`` runs the plain version only for tensors on the CPU. For CUDA
tensors it launches ``moe_gmm.cu`` or raises; it never falls back.
``gmm.launches`` counts the kernel launches, one per call.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels._grad import refuse_grad

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(x, w):
    if x.ndim != 3 or w.ndim != 3 or x.shape[0] != w.shape[0] \
            or x.shape[2] != w.shape[1]:
        raise ValueError(f"x must be (E, C, K) and w (E, K, F), got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    if x.dtype != w.dtype or x.dtype not in _DTYPES:
        raise TypeError(f"x/w must share a dtype in {list(_DTYPES)}, got "
                        f"{x.dtype}, {w.dtype}")
    if x.device != w.device:
        raise ValueError("x/w must be on one device")


def gmm_reference(x, w):
    """Plain version (``ref.py::gmm_ref``): the per-expert product in fp32,
    rounded once to x's dtype. x (E, C, K), w (E, K, F) -> (E, C, F)."""
    _check(x, w)
    return torch.einsum("eck,ekf->ecf", x.float(), w.float()).to(x.dtype)


_FN = None
#: the instances ``moe_gmm.cu`` launches, by the code it reports:
#: fp32 on CUDA cores; bf16 on tensor cores with the operands swapped
#: (C <= 8, C <= 16), with 64 x 128 or 128 x 128 tiles, and with masked
#: scalar loads for K or F not a multiple of 8 or unaligned pointers
INSTANCES = ("fp32_cuda_cores", "bf16_tc_swap_c8", "bf16_tc_swap_c16",
             "bf16_tc_64x128", "bf16_tc_128x128", "bf16_tc_64x128_scalar")


def _kernel():
    global _FN
    if _FN is None:
        from repro_torch.kernels._build import library
        fn = library("moe_gmm").repro_moe_gmm
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, i32, i32, i32, i32, i32, vp,
                       ctypes.POINTER(i32)]
        fn.restype = i32
        _FN = fn
    return _FN


def gmm(x, w, *, instance: str | None = None):
    """x: (E, C, K); w: (E, K, F) -> (E, C, F) = x[e] @ w[e] per expert,
    accumulated in fp32 and returned in x's dtype. Any C, K, F (no block
    multiple). CUDA tensors must be contiguous, float32 or bfloat16;
    ``gmm.last_instance`` then names the kernel instance that ran
    (``INSTANCES``). ``instance`` forces a bf16 instance by name where it
    can run the shape, to time instances against each other (the kernel
    refuses one that cannot); None chooses it from the shape. The CPU
    runs the plain version whatever it names."""
    _check(x, w)
    if instance is not None and instance not in INSTANCES[1:]:
        raise ValueError(f"instance must be one of {INSTANCES[1:]}, got "
                         f"{instance!r}")
    if x.device.type == "cpu":
        return gmm_reference(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"gmm runs on cuda or cpu tensors, got {x.device}")
    refuse_grad("gmm", x, w)
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("gmm's CUDA kernel needs contiguous x/w")
    e, c, k = x.shape
    f = w.shape[2]
    out = torch.empty((e, c, f), dtype=x.dtype, device=x.device)
    taken = ctypes.c_int(-1 if instance is None
                         else INSTANCES.index(instance))
    rc = _kernel()(x.data_ptr(), w.data_ptr(), out.data_ptr(), e, c, k, f,
                   _DTYPES[x.dtype],
                   torch.cuda.current_stream(x.device).cuda_stream,
                   ctypes.byref(taken))
    if rc:
        raise RuntimeError(f"moe_gmm launch failed: CUDA error {rc}")
    gmm.launches += 1
    gmm.last_instance = INSTANCES[taken.value]
    return out


gmm.launches = 0
gmm.last_instance = None


def expert_mlp(x, w_gate, w_up, w_down):
    """SwiGLU expert FFN (``repro/kernels/moe_gmm/ops.py::expert_mlp``):
    x (E, C, d); w_gate/w_up (E, d, f); w_down (E, f, d) -> (E, C, d), with
    ``h = silu(gate) * up`` in fp32 cast to x's dtype. Three ``gmm``
    launches."""
    g = gmm(x, w_gate)
    u = gmm(x, w_up)
    h = (F.silu(g.float()) * u.float()).to(x.dtype)
    return gmm(h, w_down)
