"""PyTorch + CUDA port of the FrugalGPT serving system (``repro``).

The package mirrors ``repro``'s layout and keeps its public names and
array layouts, so a reader finds each function's counterpart there. It
imports ``torch`` and numpy, never ``jax`` and never ``repro``.

Entry points take ``device=`` and default to ``"cuda"``; without a card
they raise unless the caller asks for ``device="cpu"`` (see
``repro_torch.device.resolve_device``).
"""
