"""Device selection for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The ``torch.device`` an entry point runs on.

    ``"cuda"`` is every entry point's default and raises when no card is
    present: the port never drops to the CPU unless the caller asks for
    ``device="cpu"`` (as the CPU tests do).
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' but torch.cuda.is_available() is False; "
                "pass device='cpu' to run the plain PyTorch path")
        # The encoders are float32 (models.classifier.encoder_config).
        # TF32 keeps ~3 decimal digits, which would break parity with the
        # plain versions and the JAX reference, so both switches stay off.
        # The reference's bf16 matmuls sum in fp32 and round once
        # (preferred_element_type=float32); cuBLAS may otherwise round
        # split-K partial sums to bf16.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}; expected 'cuda' "
                         "or 'cpu'")
    return dev
