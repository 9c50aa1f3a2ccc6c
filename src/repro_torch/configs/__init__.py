"""Architecture registry: one exact public-literature config per file."""

from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import (
    ATTN,
    ENC_ATTN,
    LOCAL,
    RGLRU,
    SSM,
    SHAPES,
    ModelConfig,
    MoEConfig,
    RGLRUConfig,
    SSMConfig,
    ShapeConfig,
    reduced_config,
)
from repro_torch.configs.whisper_large_v3 import CONFIG as WHISPER_LARGE_V3
from repro_torch.configs.internvl2_1b import CONFIG as INTERNVL2_1B
from repro_torch.configs.recurrentgemma_2b import CONFIG as RECURRENTGEMMA_2B
from repro_torch.configs.deepseek_coder_33b import CONFIG as DEEPSEEK_CODER_33B
from repro_torch.configs.llama3_2_3b import CONFIG as LLAMA3_2_3B
from repro_torch.configs.deepseek_67b import CONFIG as DEEPSEEK_67B
from repro_torch.configs.gemma2_2b import CONFIG as GEMMA2_2B
from repro_torch.configs.llama4_maverick_400b import CONFIG as LLAMA4_MAVERICK_400B
from repro_torch.configs.olmoe_1b_7b import CONFIG as OLMOE_1B_7B
from repro_torch.configs.mamba2_130m import CONFIG as MAMBA2_130M

ARCHS: Dict[str, ModelConfig] = {
    c.name: c
    for c in (
        WHISPER_LARGE_V3,
        INTERNVL2_1B,
        RECURRENTGEMMA_2B,
        DEEPSEEK_CODER_33B,
        LLAMA3_2_3B,
        DEEPSEEK_67B,
        GEMMA2_2B,
        LLAMA4_MAVERICK_400B,
        OLMOE_1B_7B,
        MAMBA2_130M,
    )
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = [
    "ARCHS",
    "SHAPES",
    "get_config",
    "reduced_config",
    "ModelConfig",
    "MoEConfig",
    "SSMConfig",
    "RGLRUConfig",
    "ShapeConfig",
    "ATTN",
    "LOCAL",
    "SSM",
    "RGLRU",
    "ENC_ATTN",
]
