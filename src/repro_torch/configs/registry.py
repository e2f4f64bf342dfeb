"""Architecture registry of the port: ``--arch <id>`` resolution.

Only the dense decoder archs are ported so far; the other families of the
reference registry join with their model code (ROADMAP Queue A items 10-12).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import gemma3_1b, qwen2_1p5b
from repro_torch.configs.base import ModelConfig

ARCHS: Dict[str, ModelConfig] = {
    c.name: c for c in (gemma3_1b.CONFIG, qwen2_1p5b.CONFIG)
}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; choose from {sorted(ARCHS)}")
    return ARCHS[name]
