"""Config registry — ``--arch <id>`` resolution.

>>> from repro_torch.configs import get_config, ARCHS
>>> cfg = get_config("qwen3-14b")
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ShapeCell, SHAPE_CELLS, SHAPES, validate

from repro_torch.configs import (
    minicpm_2b,
    h2o_danube_1_8b,
    stablelm_12b,
    qwen3_14b,
    falcon_mamba_7b,
    deepseek_v2_lite_16b,
    dbrx_132b,
    zamba2_1_2b,
    internvl2_76b,
    whisper_base,
)

_MODULES = (
    minicpm_2b,
    h2o_danube_1_8b,
    stablelm_12b,
    qwen3_14b,
    falcon_mamba_7b,
    deepseek_v2_lite_16b,
    dbrx_132b,
    zamba2_1_2b,
    internvl2_76b,
    whisper_base,
)

REGISTRY = {m.CONFIG.name: m.CONFIG for m in _MODULES}
ARCHS = tuple(REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {', '.join(ARCHS)}")
    cfg = REGISTRY[name]
    validate(cfg)
    return cfg


__all__ = [
    "ModelConfig",
    "ShapeCell",
    "SHAPE_CELLS",
    "SHAPES",
    "REGISTRY",
    "ARCHS",
    "get_config",
    "validate",
]
