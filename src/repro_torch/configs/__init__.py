"""Architecture registry: ``get_config(name)`` / ``--arch <id>``."""
from __future__ import annotations

from typing import Dict

from .base import ModelConfig, ShapeCfg, Stage, dense_stages, lm_shapes
from . import (
    dbrx_132b,
    gemma3_27b,
    gemma_2b,
    jamba_1_5_large_398b,
    musicgen_large,
    olmo_1b,
    qwen2_vl_2b,
    qwen3_14b,
    qwen3_moe_30b_a3b,
    xlstm_1_3b,
)

ARCHS: Dict[str, ModelConfig] = {
    cfg.name: cfg
    for cfg in (
        qwen3_14b.CONFIG,
        gemma_2b.CONFIG,
        gemma3_27b.CONFIG,
        olmo_1b.CONFIG,
        musicgen_large.CONFIG,
        qwen2_vl_2b.CONFIG,
        dbrx_132b.CONFIG,
        qwen3_moe_30b_a3b.CONFIG,
        jamba_1_5_large_398b.CONFIG,
        xlstm_1_3b.CONFIG,
    )
}


def get_config(name: str) -> ModelConfig:
    if name.endswith("-tiny"):
        return ARCHS[name[: -len("-tiny")]].tiny()
    return ARCHS[name]


def arch_names() -> list:
    return list(ARCHS.keys())


__all__ = ["ARCHS", "get_config", "arch_names", "ModelConfig", "ShapeCfg", "Stage",
           "dense_stages", "lm_shapes"]
