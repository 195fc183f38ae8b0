"""Architecture registry of the port: the configs it can run.

Holds the reference's dense, MoE, SSM and hybrid configs
(``repro/configs/registry.py`` lists ten). DeepSeek-V3 (MLA), Qwen2-VL
(mrope) and HuBERT (precomputed audio embeddings) join when their layers
are ported.
"""
from __future__ import annotations

from repro_torch.configs import (gemma3_1b, granite_moe_1b_a400m,
                                 jamba_v0_1_52b, mamba2_1_3b,
                                 mistral_nemo_12b, moonshot_v1_16b_a3b,
                                 starcoder2_15b)
from repro_torch.configs.base import ModelConfig

ARCHS: dict[str, ModelConfig] = {
    c.name: c
    for c in [
        starcoder2_15b.CONFIG,
        granite_moe_1b_a400m.CONFIG,
        mamba2_1_3b.CONFIG,
        mistral_nemo_12b.CONFIG,
        moonshot_v1_16b_a3b.CONFIG,
        jamba_v0_1_52b.CONFIG,
        gemma3_1b.CONFIG,
    ]
}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]
