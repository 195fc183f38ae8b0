"""Mistral-Nemo-12B [hf:mistralai/Mistral-Nemo-Base-2407] — dense GQA, 128k ctx.

The reference's config (``repro/configs/mistral_nemo_12b.py``), field for
field.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

_L = LayerSpec(mixer="attn", ffn="dense")

CONFIG = ModelConfig(
    name="mistral-nemo-12b",
    arch_type="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,            # q_dim 4096 != d_model (Nemo head_dim override)
    d_ff=14336,
    vocab=131_072,
    period=(_L,),
    n_periods=40,
    pos="rope",
    rope_theta=1_000_000.0,
    ffn_act="swiglu",
    max_seq=131_072,
    source="hf:mistralai/Mistral-Nemo-Base-2407 (GQA kv=8, head_dim=128, 128k)",
)
