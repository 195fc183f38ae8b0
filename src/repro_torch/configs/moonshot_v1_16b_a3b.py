"""Moonlight-16B-A3B [hf:moonshotai/Moonlight-16B-A3B] — MoE 64e top-6 (+2 shared).

The reference's config (``repro/configs/moonshot_v1_16b_a3b.py``), field
for field: GQA with kv = 16 (so MHA), a dense first layer, then MoE
layers with two shared experts. The port runs it reduced, on the CPU.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, MoECfg

_DENSE = LayerSpec(mixer="attn", ffn="dense")
_MOE = LayerSpec(mixer="attn", ffn="moe")

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    arch_type="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,               # per-expert width (also dense-prefix width x8)
    vocab=163_840,
    prefix=(_DENSE,),
    period=(_MOE,),
    n_periods=47,
    moe=MoECfg(n_experts=64, top_k=6, d_expert=1408, n_shared=2,
               capacity_factor=1.25),
    pos="rope",
    rope_theta=50_000.0,
    ffn_act="swiglu",
    max_seq=8192,
    source="hf:moonshotai/Moonlight-16B-A3B (64 routed top-6, 2 shared)",
)
