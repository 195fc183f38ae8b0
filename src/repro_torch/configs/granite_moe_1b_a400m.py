"""Granite-3.0-1B-A400M [hf:ibm-granite/granite-3.0-1b-a400m-base] — 32e top-8 MoE.

The reference's config (``repro/configs/granite_moe_1b_a400m.py``), field
for field.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, MoECfg

_L = LayerSpec(mixer="attn", ffn="moe")

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    arch_type="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,                # per-expert width
    vocab=49_155,
    period=(_L,),
    n_periods=24,
    moe=MoECfg(n_experts=32, top_k=8, d_expert=512, n_shared=0,
               capacity_factor=1.25),
    pos="rope",
    ffn_act="swiglu",
    tie_embeddings=True,
    max_seq=8192,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base (32 experts top-8)",
)
