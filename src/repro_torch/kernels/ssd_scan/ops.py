"""Mamba-2 SSD chunked scan: the CUDA kernel's wrapper ``ssd_scan``, its
plain PyTorch version ``ssd_reference`` (a port of the reference model's
``ssd_chunked``, ``repro/models/ssm.py``), and ``ssd``, which adds the D
skip term (``repro/kernels/ssd_scan/ops.py``) and is what the Mamba
mixer's prefill calls.

``ssd_scan`` runs the plain version only for tensors on the CPU. For CUDA
tensors it launches ``ssd_scan.cu`` or raises; it never falls back.
``ssd_scan.launches`` counts the kernel launches, one per call.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._grad import refuse_grad

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: dynamic shared memory one block may use on an H100 (227 KB)
MAX_SMEM = 232_448


def _check(x, dt, a, bm, cm, chunk):
    if x.ndim != 4 or dt.shape != x.shape[:3] or a.shape != x.shape[2:3] \
            or bm.ndim != 3 or bm.shape[:2] != x.shape[:2] \
            or cm.shape != bm.shape:
        raise ValueError(f"x must be (B, S, H, P), dt (B, S, H), a (H,) and "
                         f"bm/cm (B, S, N), got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(a.shape)}, "
                         f"{tuple(bm.shape)}, {tuple(cm.shape)}")
    if not (x.dtype == bm.dtype == cm.dtype) or x.dtype not in _DTYPES:
        raise TypeError(f"x/bm/cm must share a dtype in {list(_DTYPES)}, "
                        f"got {x.dtype}, {bm.dtype}, {cm.dtype}")
    if len({t.device for t in (x, dt, a, bm, cm)}) != 1:
        raise ValueError("x/dt/a/bm/cm must be on one device")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")


def ssd_reference(x, dt, a, bm, cm, *, chunk: int, init_state=None):
    """Plain version, ``ssd_chunked`` line for line: x (B, S, H, P), dt
    (B, S, H), a (H,) < 0, bm/cm (B, S, N). Returns (y (B, S, H, P) in x's
    dtype, final state (B, H, P, N) fp32), y = SSD(x * dt) without D.
    A ragged tail is padded with dt = 0 (an identity step). The
    intra-chunk product rounds its weights and x * dt to x's dtype, as the
    reference does; cumsums, exponents and the state stay fp32."""
    _check(x, dt, a, bm, cm, chunk)
    b, s, h, p = x.shape
    n = bm.shape[-1]
    s_orig = s
    if s % chunk:
        pad = chunk - s % chunk
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        bm = torch.nn.functional.pad(bm, (0, 0, 0, pad))
        cm = torch.nn.functional.pad(cm, (0, 0, 0, pad))
        s = s + pad
    c, q = s // chunk, chunk
    xr = (x * dt[..., None]).float().reshape(b, c, q, h, p)
    da = (dt.float() * a.float()).reshape(b, c, q, h)
    da_cs = torch.cumsum(da, dim=2)                             # inclusive
    da_sum = da_cs[:, :, -1]                                    # (b,c,h)
    br = bm.float().reshape(b, c, q, n)
    cr = cm.float().reshape(b, c, q, n)

    diff = da_cs[:, :, :, None, :] - da_cs[:, :, None, :, :]    # (b,c,i,j,h)
    causal = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    lmat = torch.exp(diff.masked_fill(~causal[None, None, :, :, None],
                                      float("-inf")))
    scores = torch.einsum("bcin,bcjn->bcij", cr, br)
    m = (scores[..., None] * lmat).to(x.dtype).float()          # (b,c,i,j,h)
    y_diag = torch.einsum("bcijh,bcjhp->bcihp", m,
                          xr.to(x.dtype).float())

    decay_end = torch.exp(da_sum[:, :, None, :] - da_cs)        # (b,c,q,h)
    states = torch.einsum("bcqn,bcqh,bcqhp->bchpn", br, decay_end, xr)

    state = (torch.zeros(b, h, p, n, device=x.device) if init_state is None
             else init_state.float())
    entry = []
    for ci in range(c):                             # inter-chunk recurrence
        entry.append(state)
        state = torch.exp(da_sum[:, ci])[:, :, None, None] * state \
            + states[:, ci]
    entry = torch.stack(entry, 1)                               # (b,c,h,p,n)

    y_off = torch.einsum("bcqn,bcqh,bchpn->bcqhp", cr, torch.exp(da_cs),
                         entry)
    y = (y_diag + y_off).reshape(b, s, h, p)[:, :s_orig]
    return y.to(x.dtype), state


_FN = None
_SMEM = None
#: the kernel's paths, by the code it reports: a chunk whose B, C and x fit
#: shared memory in one pass (up to 253 steps in bf16, 139 in fp32 at P 64,
#: N 128), a longer one in sub-tiles
PATHS = ("single_pass", "sub_tiled")


def _kernel():
    global _FN, _SMEM
    if _FN is None:
        from repro_torch.kernels._build import library
        lib = library("ssd_scan")
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        fn = lib.repro_ssd_scan
        fn.argtypes = [vp] * 7 + [i32] * 7 + [vp, ctypes.POINTER(i32)]
        fn.restype = i32
        smem = lib.repro_ssd_scan_smem
        smem.argtypes = [i32] * 4
        smem.restype = ctypes.c_longlong
        _FN, _SMEM = fn, smem
    return _FN, _SMEM


def ssd_scan(x, dt, a, bm, cm, *, chunk: int, return_state: bool = False,
             path: str | None = None):
    """y = SSD(x * dt) without the D term, chunk by chunk of ``chunk``
    steps; with ``return_state`` also the fp32 state after the last token,
    (B, H, P, N). x (B, S, H, P), dt (B, S, H), a (H,) < 0, bm/cm (B, S, N);
    any S (a ragged last chunk runs its true rows only) and any chunk
    length. dt and a are taken in fp32. CUDA tensors x/bm/cm must be
    contiguous, float32 or bfloat16, with a head dim P and state N whose
    tiles fit the kernel's shared memory (P 64, N 128 do in either type);
    ``ssd_scan.last_path`` then names the path the kernel took
    (``PATHS``). ``path`` forces one of ``PATHS`` where its tiles fit, to
    time the two against each other (the kernel refuses one that does
    not); None chooses it from the shared memory the chunk needs. The CPU
    runs the plain version whatever it names."""
    _check(x, dt, a, bm, cm, chunk)
    if path is not None and path not in PATHS:
        raise ValueError(f"path must be one of {PATHS}, got {path!r}")
    if x.device.type == "cpu":
        y, state = ssd_reference(x, dt, a, bm, cm, chunk=chunk)
        return (y, state) if return_state else y
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on cuda or cpu tensors, got "
                         f"{x.device}")
    refuse_grad("ssd_scan", x, dt, a, bm, cm)
    if not (x.is_contiguous() and bm.is_contiguous() and cm.is_contiguous()):
        raise ValueError("ssd_scan's CUDA kernel needs contiguous x/bm/cm")
    b, s, h, p = x.shape
    n = bm.shape[-1]
    q = min(chunk, s)
    fn, smem = _kernel()
    need = smem(q, p, n, _DTYPES[x.dtype])
    if need > MAX_SMEM:
        raise ValueError(f"head dim P {p} and state N {n} in {x.dtype} need "
                         f"{need} bytes of shared memory > {MAX_SMEM}")
    dt = dt.float().contiguous()
    a = a.float().contiguous()
    y = torch.empty_like(x)
    state = (torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
             if return_state else None)
    taken = ctypes.c_int(-1 if path is None else PATHS.index(path))
    rc = fn(x.data_ptr(), dt.data_ptr(), a.data_ptr(), bm.data_ptr(),
            cm.data_ptr(), y.data_ptr(),
            None if state is None else state.data_ptr(), b, s, h, p, n, q,
            _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream,
            ctypes.byref(taken))
    if rc:
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {rc}")
    ssd_scan.launches += 1
    ssd_scan.last_path = PATHS[taken.value]
    return (y, state) if return_state else y


ssd_scan.launches = 0
ssd_scan.last_path = None


def ssd(x, dt, a, bm, cm, d=None, *, chunk: int,
        return_state: bool = False):
    """The SSD mixer core: y = SSD(x, dt, A, B, C) [+ D * x], and with
    ``return_state`` the fp32 final state. D (H,) is fp32, so y with the
    D term is fp32, as in the reference's prefill."""
    out = ssd_scan(x, dt, a, bm, cm, chunk=chunk, return_state=return_state)
    y, state = out if return_state else (out, None)
    if d is not None:
        y = y + d[:, None] * x
    return (y, state) if return_state else y
