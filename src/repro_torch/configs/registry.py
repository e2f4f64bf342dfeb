"""Architecture registry of the port: ``--arch <id>`` resolution.

The dense, SSM and hybrid archs are ported; the other families of the
reference registry join with their model code (ROADMAP Queue A items 11-12).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import (gemma3_1b, mamba2_370m, qwen2_1p5b,
                                 zamba2_2p7b)
from repro_torch.configs.base import ModelConfig

ARCHS: Dict[str, ModelConfig] = {
    c.name: c for c in (gemma3_1b.CONFIG, qwen2_1p5b.CONFIG,
                        mamba2_370m.CONFIG, zamba2_2p7b.CONFIG)
}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; choose from {sorted(ARCHS)}")
    return ARCHS[name]
