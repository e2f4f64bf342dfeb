"""Confidence metrics over S-ML output logits (paper §4).

All metrics are oriented so HIGHER = more confident and live in [0, 1], which
keeps the paper's threshold rule ``offload iff conf < theta`` uniform.
``kernels/hi_gate.py`` fuses :func:`confidence` + threshold into one kernel;
this module is its oracle.
"""
from __future__ import annotations

import math

import torch

METRICS = ("max_prob", "margin", "entropy")


def max_prob(logits: torch.Tensor) -> torch.Tensor:
    """(..., C) -> (...): max softmax probability (the paper's p)."""
    return torch.softmax(logits.float(), dim=-1).amax(dim=-1)


def margin(logits: torch.Tensor) -> torch.Tensor:
    """Top1 - top2 softmax probability."""
    top2 = torch.softmax(logits.float(), dim=-1).topk(2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


def entropy_conf(logits: torch.Tensor) -> torch.Tensor:
    """1 - H(p)/log(C): 1 = deterministic pmf, 0 = uniform."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    h = -(logp.exp() * logp).sum(dim=-1)
    return 1.0 - h / math.log(logits.shape[-1])


def binary_prob(logits: torch.Tensor) -> torch.Tensor:
    """Sigmoid score for single-logit binary heads (§5 dog filter)."""
    return torch.sigmoid(logits.float())[..., 0]


def confidence(logits: torch.Tensor, metric: str = "max_prob") -> torch.Tensor:
    if logits.shape[-1] == 1:
        return binary_prob(logits)
    if metric == "max_prob":
        return max_prob(logits)
    if metric == "margin":
        return margin(logits)
    if metric == "entropy":
        return entropy_conf(logits)
    raise ValueError(f"unknown confidence metric {metric!r}")
