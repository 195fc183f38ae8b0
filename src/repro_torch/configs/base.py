"""Model configs for the port (mirrors ``repro/configs/base.py``).

A stack is described as ``prefix ++ (period * n_periods) ++ suffix`` of
``LayerSpec`` entries; the port runs it as a plain loop over ``layers``.
Supported: attention mixers (full or sliding window) and Mamba-2 mixers,
dense FFNs with gelu / geglu / swiglu and MoE FFNs, layernorm or
rmsnorm, absolute, rope or no positions, float32 or bfloat16. MLA and
mrope are refused with an error until their slice is ported, rather than
silently mis-run; the config has no MLA field to set.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

_MIXERS = ("attn", "attn_sliding", "mamba")
_FFNS = ("dense", "moe", "none")


@dataclasses.dataclass(frozen=True)
class MoECfg:
    """Mixture-of-experts FFN config (capacity-based routing)."""

    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int = 0            # shared (always-on) experts
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    """Mamba-2 SSD mixer config."""

    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    d_conv: int = 4
    chunk: int = 256             # SSD chunk length


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One transformer sub-layer: a sequence mixer + an FFN."""

    mixer: str                   # "attn" | "attn_sliding" | "mamba"
    ffn: str                     # "dense" | "moe" | "none"

    def __post_init__(self):
        if self.mixer not in _MIXERS:
            raise ValueError(f"mixer {self.mixer!r} is not ported; expected "
                             f"one of {_MIXERS}")
        if self.ffn not in _FFNS:
            raise ValueError(f"ffn {self.ffn!r} is not ported; expected one "
                             f"of {_FFNS}")


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

    moe: Optional[MoECfg] = None
    ssm: Optional[SSMCfg] = None

    pos: str = "rope"            # "rope" | "abs" | "none"
    rope_theta: float = 10_000.0
    window: int = 0              # sliding-window size for attn_sliding
    causal: bool = True          # False => encoder-only (no decode)
    ffn_act: str = "swiglu"      # "swiglu" | "gelu" | "geglu"
    norm: str = "rmsnorm"        # "rmsnorm" | "layernorm"
    tie_embeddings: bool = False
    max_seq: int = 131_072
    dtype: str = "bfloat16"      # compute dtype: "float32" | "bfloat16"
    # citation for the config numbers
    source: str = ""

    def __post_init__(self):
        got = len(self.layers)
        if got != self.n_layers:
            raise ValueError(f"{self.name}: layer pattern covers {got} "
                             f"layers, expected {self.n_layers}")
        for field, value, ok in (
                ("pos", self.pos, ("rope", "abs", "none")),
                ("ffn_act", self.ffn_act, ("gelu", "geglu", "swiglu")),
                ("norm", self.norm, ("layernorm", "rmsnorm")),
                ("dtype", self.dtype, ("float32", "bfloat16"))):
            if value not in ok:
                raise ValueError(f"{field}={value!r} is not ported; expected "
                                 f"one of {ok}")
        kinds = {s.mixer for s in self.layers} | {s.ffn for s in self.layers}
        for kind, field, sub in (("moe", "moe", self.moe),
                                 ("mamba", "ssm", self.ssm)):
            if kind in kinds and sub is None:
                raise ValueError(f"{self.name}: {kind} layers need {field}=")
        if self.has_attention and (self.n_kv_heads <= 0
                                   or self.n_heads % self.n_kv_heads):
            raise ValueError(f"n_heads={self.n_heads} must be a positive "
                             f"multiple of n_kv_heads={self.n_kv_heads}")

    @property
    def layers(self) -> Tuple[LayerSpec, ...]:
        """The flattened per-layer spec list."""
        return self.prefix + self.period * self.n_periods + self.suffix

    @property
    def has_attention(self) -> bool:
        return any(s.mixer.startswith("attn") for s in self.layers)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def decode_supported(self) -> bool:
        return self.causal

    def reduced(self) -> "ModelConfig":
        """The reference's 2-layer CPU variant of the same family
        (``repro/configs/base.py::reduced``): d_model <= 256, head_dim
        <= 64, <= 4 heads, d_ff <= 512, vocab <= 1024, window <= 64,
        max_seq 512, float32; <= 4 experts, top-2, d_expert <= 128, <= 1
        shared expert; SSM d_state 16, head_dim 32, chunk 32. The 2 layers
        are the first period's head (so Gemma-3 keeps two sliding layers),
        else the prefix's."""
        d_model = min(self.d_model, 256)
        head_dim = min(self.head_dim, 64) if self.head_dim else 0
        n_heads = min(self.n_heads, 4) if self.n_heads else 0
        n_kv = (min(self.n_kv_heads, max(1, n_heads // 2))
                if self.n_kv_heads else 0)
        if self.n_kv_heads == self.n_heads:  # keep MHA archs MHA
            n_kv = n_heads
        moe = ssm = None
        if self.moe is not None:
            moe = dataclasses.replace(
                self.moe, n_experts=min(self.moe.n_experts, 4),
                top_k=min(self.moe.top_k, 2),
                d_expert=min(self.moe.d_expert, 128),
                n_shared=min(self.moe.n_shared, 1))
        if self.ssm is not None:
            ssm = dataclasses.replace(self.ssm, d_state=16, head_dim=32,
                                      chunk=32)
        if self.period:
            period = self.period[:2] if len(self.period) >= 2 else self.period
            n_periods = 2 // len(period)
            rem = 2 - n_periods * len(period)
            prefix = self.prefix[:rem]
            if len(prefix) < rem:  # pad from period
                prefix = (self.period[0],) * rem
            suffix = ()
        else:
            prefix, period, n_periods, suffix = self.prefix[:2], (), 0, ()
        n_layers = len(prefix) + len(period) * n_periods + len(suffix)
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=n_layers,
            d_model=d_model,
            d_ff=min(self.d_ff, 512),
            vocab=min(self.vocab, 1024),
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=head_dim,
            prefix=prefix,
            period=period,
            n_periods=n_periods,
            suffix=suffix,
            moe=moe,
            ssm=ssm,
            window=min(self.window, 64) if self.window else 0,
            max_seq=512,
            dtype="float32",
        )
