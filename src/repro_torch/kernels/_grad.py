"""The CUDA wrappers' autograd guard.

A kernel wrapper writes its CUDA result into a fresh tensor through
ctypes, so the result carries no ``grad_fn``: a loss computed from it
would give no gradient to anything before the kernel, and nothing would
fail. Until a kernel has a backward (a ``torch.autograd.Function`` whose
backward is a kernel too), its wrapper refuses such inputs on the card.
The CPU path runs the plain PyTorch version, which differentiates.
"""
from __future__ import annotations

import torch


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise ``RuntimeError`` when grad mode is on and any floating-point
    tensor of ``tensors`` requires grad."""
    if not torch.is_grad_enabled():
        return
    if any(t.requires_grad and t.is_floating_point() for t in tensors):
        raise RuntimeError(
            f"{name}: its CUDA kernel has no backward yet, and an input "
            f"requires grad; call it under torch.no_grad() (or "
            f"torch.inference_mode()), or run the plain version on the CPU")
