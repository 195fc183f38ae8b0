"""Jamba-v0.1-52B [arXiv:2403.19887] — hybrid Mamba+attn 1:7, MoE 16e top-2.

The reference's config (``repro/configs/jamba_v0_1_52b.py``), field for
field: an 8-layer block with one attention layer (index 3) and MoE on
every other layer, with the Mamba-2 SSD mixer (d_state 128) in place of
Jamba v0.1's Mamba-1, as the reference adapts it. At ~104 GB in bf16 it
does not fit one card; the port runs it reduced, on the CPU.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, MoECfg, SSMCfg

_M_D = LayerSpec(mixer="mamba", ffn="dense")
_M_E = LayerSpec(mixer="mamba", ffn="moe")
_A_E = LayerSpec(mixer="attn", ffn="moe")

# 8-layer Jamba block: attn at index 3, MoE on odd indices.
_PERIOD = (_M_D, _M_E, _M_D, _A_E, _M_D, _M_E, _M_D, _M_E)

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    arch_type="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=65_536,
    period=_PERIOD,
    n_periods=4,
    moe=MoECfg(n_experts=16, top_k=2, d_expert=14336, n_shared=0,
               capacity_factor=1.25),
    ssm=SSMCfg(d_state=128, head_dim=64, expand=2, d_conv=4, chunk=256),
    pos="rope",                 # attn layers only; mamba layers position-free
    ffn_act="swiglu",
    max_seq=1_048_576,
    source="arXiv:2403.19887 (1:7 attn:mamba, MoE 16e top-2 every other layer)",
)
