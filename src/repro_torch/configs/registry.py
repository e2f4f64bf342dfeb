"""Architecture registry of the port: ``--arch <id>`` resolution, the
reference registry's ten archs, and the assigned shapes with their skip
rule."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import (arctic_480b, deepseek_moe_16b, gemma3_1b,
                                 granite_3_2b, h2o_danube_3_4b,
                                 llava_next_34b, mamba2_370m, qwen2_1p5b,
                                 whisper_large_v3, zamba2_2p7b)
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig

ARCHS: Dict[str, ModelConfig] = {
    c.name: c
    for c in (
        mamba2_370m.CONFIG,
        deepseek_moe_16b.CONFIG,
        whisper_large_v3.CONFIG,
        granite_3_2b.CONFIG,
        zamba2_2p7b.CONFIG,
        gemma3_1b.CONFIG,
        llava_next_34b.CONFIG,
        arctic_480b.CONFIG,
        qwen2_1p5b.CONFIG,
        h2o_danube_3_4b.CONFIG,
    )
}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; choose from {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; choose from {sorted(SHAPES)}")
    return SHAPES[name]


def shape_applicable(arch: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Assignment skip rules.  Returns (applicable, reason-if-not)."""
    if shape.name == "long_500k":
        if arch.family == "encdec":
            return False, "enc-dec audio model: no 500k-token decode exists"
        if not arch.sub_quadratic:
            return False, ("pure full-attention arch: long_500k requires "
                           "sub-quadratic attention")
    return True, ""
