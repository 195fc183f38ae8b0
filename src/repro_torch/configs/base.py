"""Model configs for the port: the fields the encoder stack reads.

Mirrors ``repro/configs/base.py``. A stack is described as
``prefix ++ (period * n_periods) ++ suffix`` of ``LayerSpec`` entries;
the port runs it as a plain loop over ``layers``. Only what the
marketplace encoders and the scorer use is supported in this slice
(attention mixers, dense gelu FFN, layernorm, absolute or no positions);
other values are refused rather than silently mis-run.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

_MIXERS = ("attn", "attn_sliding")
_FFNS = ("dense", "none")


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One transformer sub-layer: a sequence mixer + an FFN."""

    mixer: str                   # "attn" | "attn_sliding"
    ffn: str                     # "dense" | "none"

    def __post_init__(self):
        if self.mixer not in _MIXERS:
            raise ValueError(f"mixer {self.mixer!r} is not ported; "
                             f"expected one of {_MIXERS}")
        if self.ffn not in _FFNS:
            raise ValueError(f"ffn {self.ffn!r} is not ported; expected "
                             f"one of {_FFNS}")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str
    n_layers: int
    d_model: int
    d_ff: int
    vocab: int
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0

    # layer pattern: prefix ++ period*n_periods ++ suffix
    prefix: Tuple[LayerSpec, ...] = ()
    period: Tuple[LayerSpec, ...] = ()
    n_periods: int = 0
    suffix: Tuple[LayerSpec, ...] = ()

    pos: str = "abs"             # "abs" | "none"
    window: int = 0              # sliding-window size for attn_sliding
    causal: bool = True          # False => encoder-only
    ffn_act: str = "gelu"
    norm: str = "layernorm"
    tie_embeddings: bool = False
    max_seq: int = 131_072
    dtype: str = "float32"

    def __post_init__(self):
        got = len(self.prefix) + len(self.period) * self.n_periods + len(self.suffix)
        if got != self.n_layers:
            raise ValueError(f"{self.name}: layer pattern covers {got} "
                             f"layers, expected {self.n_layers}")
        for field, value, ok in (("pos", self.pos, ("abs", "none")),
                                 ("ffn_act", self.ffn_act, ("gelu",)),
                                 ("norm", self.norm, ("layernorm",)),
                                 ("dtype", self.dtype, ("float32",))):
            if value not in ok:
                raise ValueError(f"{field}={value!r} is not ported; "
                                 f"expected one of {ok}")
        if self.n_kv_heads <= 0 or self.n_heads % self.n_kv_heads:
            raise ValueError(f"n_heads={self.n_heads} must be a positive "
                             f"multiple of n_kv_heads={self.n_kv_heads}")

    @property
    def layers(self) -> Tuple[LayerSpec, ...]:
        """The flattened per-layer spec list."""
        return self.prefix + self.period * self.n_periods + self.suffix

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim
