"""Gemma-3-1B [hf:google/gemma-3-1b-pt] — 5:1 local:global sliding attention.

The reference's config (``repro/configs/gemma3_1b.py``), field for field.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

_LOCAL = LayerSpec(mixer="attn_sliding", ffn="dense")
_GLOBAL = LayerSpec(mixer="attn", ffn="dense")

# 26 layers = 4 x (5 local + 1 global) + 2 local suffix
_PERIOD = (_LOCAL, _LOCAL, _LOCAL, _LOCAL, _LOCAL, _GLOBAL)

CONFIG = ModelConfig(
    name="gemma3-1b",
    arch_type="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab=262_144,
    period=_PERIOD,
    n_periods=4,
    suffix=(_LOCAL, _LOCAL),
    pos="rope",
    rope_theta=1_000_000.0,
    window=512,
    ffn_act="geglu",
    tie_embeddings=True,
    max_seq=524_288,
    source="hf:google/gemma-3-1b-pt (5:1 local:global, window 512, kv=1)",
)
