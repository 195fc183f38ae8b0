"""Architecture registry of the port: the configs it can run.

Holds only the reference's dense attention configs
(``repro/configs/registry.py`` lists ten); the MoE, SSM, hybrid, MLA,
audio and vision ones join when their layers are ported.
"""
from __future__ import annotations

from repro_torch.configs import gemma3_1b, mistral_nemo_12b, starcoder2_15b
from repro_torch.configs.base import ModelConfig

ARCHS: dict[str, ModelConfig] = {
    c.name: c
    for c in [
        starcoder2_15b.CONFIG,
        mistral_nemo_12b.CONFIG,
        gemma3_1b.CONFIG,
    ]
}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]
