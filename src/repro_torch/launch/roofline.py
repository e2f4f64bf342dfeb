"""Roofline terms of one dry-run case on one card: the reference's
``launch/hlo_analysis.py`` with the H100's constants.

  compute term    = FLOPs per card / peak FLOP/s of the params' type
  memory term     = dot bytes per card / HBM bytes/s
  collective term = collective bytes per card / NVLink bytes/s

The counts come from ``launch/counting.py`` on one rank's local shards, so
they are per card already (the reference divides its global StableHLO
count by the chips).

The constants are those of an NVIDIA H100 80GB HBM3 at its 700 W limit
(NVIDIA's data sheet, SXM part, dense rates): a card set to a lower power
limit runs slower under load.  NVLink joins the cards of one host; a
collective that crosses hosts runs at the network's rate, which no
constant here models.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import torch

BF16_FLOP_PER_S = 989e12     # dense bf16 on the tensor cores
F32_FLOP_PER_S = 67e12       # float32 FMA outside them (TF32 off)
HBM_BYTES_PER_S = 3.35e12
NVLINK_BYTES_PER_S = 450e9   # to the host's other cards, each way


def peak_flops(dtype: torch.dtype) -> float:
    """The compute roof of a case whose params are ``dtype``: float32
    products run on the FMA units (the port keeps TF32 off)."""
    return F32_FLOP_PER_S if dtype == torch.float32 else BF16_FLOP_PER_S


@dataclass
class Roofline:
    """All byte and FLOP quantities are PER CARD.  ``hlo_flops`` and
    ``hlo_bytes`` keep the reference's names: here they are the counter's
    FLOPs and dot bytes."""
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    coll_bytes: float
    coll_breakdown: Dict[str, int] = field(default_factory=dict)
    model_flops: float = 0.0
    peak_memory_bytes: float = 0.0
    flop_per_s: float = BF16_FLOP_PER_S

    @property
    def compute_s(self) -> float:
        return self.hlo_flops / self.flop_per_s

    @property
    def memory_s(self) -> float:
        return self.hlo_bytes / HBM_BYTES_PER_S

    @property
    def collective_s(self) -> float:
        return self.coll_bytes / NVLINK_BYTES_PER_S

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        """The largest term: no step can be shorter."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    def row(self) -> Dict[str, object]:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "model_flops": self.model_flops, "hlo_flops": self.hlo_flops,
            "useful_ratio": self.useful_flops_ratio,
            "peak_mem_gb": self.peak_memory_bytes / 1e9,
        }


def model_flops(n_params_active: float, tokens: float, mode: str) -> float:
    """6ND for training, 2ND for an inference forward."""
    mult = 6.0 if mode == "train" else 2.0
    return mult * n_params_active * tokens
