"""Mamba2-1.3B [arXiv:2405.21060] — attention-free SSD (state-space duality).

The reference's config (``repro/configs/mamba2_1_3b.py``), field for field.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, SSMCfg

_L = LayerSpec(mixer="mamba", ffn="none")

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    arch_type="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab=50_280,
    period=(_L,),
    n_periods=48,
    ssm=SSMCfg(d_state=128, head_dim=64, expand=2, d_conv=4, chunk=128),
    pos="none",
    ffn_act="swiglu",
    tie_embeddings=True,
    max_seq=1_048_576,
    source="arXiv:2405.21060 (SSD; d_state=128, expand=2, head_dim=64)",
)
