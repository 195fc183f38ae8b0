"""StarCoder2-15B [arXiv:2402.19173] — dense GQA + RoPE, sliding-window 4096.

The reference's config (``repro/configs/starcoder2_15b.py``), field for
field.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

_L = LayerSpec(mixer="attn_sliding", ffn="dense")

CONFIG = ModelConfig(
    name="starcoder2-15b",
    arch_type="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    head_dim=128,
    d_ff=24576,
    vocab=49152,
    period=(_L,),
    n_periods=40,
    pos="rope",
    rope_theta=100_000.0,
    window=4096,
    ffn_act="gelu",
    norm="layernorm",
    max_seq=524_288,
    source="arXiv:2402.19173 (sliding window 4096; GQA kv=4; RoPE)",
)
