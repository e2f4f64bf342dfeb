"""Uniform model API of the port.  Only the dense decoder family is ported;
every other family raises ``NotImplementedError`` naming its ROADMAP item.

  init_params(gen, cfg)                        -> float32 params dict
  forward(params, cfg, tokens)                 -> logits (B, S, V) float32
  init_cache(cfg, batch, seq_len, dtype, device) -> decode cache dict
  prefill(params, cfg, tokens, cache)          -> (logits (B, V), cache)
  decode_step(params, cfg, token, cache)       -> (logits (B, V), cache)
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import (DENSE, ENCDEC, HYBRID, MOE, SSM, VLM,
                                      ModelConfig)
from repro_torch.models import transformer

Params = Dict[str, Any]

_NOT_PORTED = {
    SSM: "ROADMAP Queue A item 10 (SSM and hybrid families)",
    HYBRID: "ROADMAP Queue A item 10 (SSM and hybrid families)",
    MOE: "ROADMAP Queue A item 11 (MoE)",
    ENCDEC: "ROADMAP Queue A item 12 (the paper's own applications: "
            "enc-dec)",
    VLM: "ROADMAP Queue A item 12 (the paper's own applications: VLM)",
}


def _dense(cfg: ModelConfig) -> None:
    if cfg.family != DENSE:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: "
            f"{_NOT_PORTED.get(cfg.family, 'unknown family')}")


def init_params(gen: torch.Generator, cfg: ModelConfig) -> Params:
    _dense(cfg)
    return transformer.init_decoder(gen, cfg)


def forward(params: Params, cfg: ModelConfig,
            tokens: torch.Tensor) -> torch.Tensor:
    _dense(cfg)
    return transformer.forward(params, cfg, tokens)


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               dtype=torch.bfloat16, device="cuda") -> Params:
    _dense(cfg)
    return transformer.init_cache(cfg, batch, seq_len, dtype, device)


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            cache: Params):
    _dense(cfg)
    return transformer.prefill(params, cfg, tokens, cache)


def decode_step(params: Params, cfg: ModelConfig, token: torch.Tensor,
                cache: Params):
    _dense(cfg)
    return transformer.decode_step(params, cfg, token, cache)
