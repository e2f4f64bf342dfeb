"""The paper's abstract cost model (§4).

Per sample i:
    C_i = beta + eta_i   if offloaded   (eta_i = 1 iff L-ML wrong)
        = gamma_i        otherwise      (gamma_i = 1 iff accepted S-ML wrong)

All quantities vectorise over a batch; totals are sums, so batched serving
reproduces the paper's per-image accounting exactly.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch


def per_sample_cost(offloaded: torch.Tensor, s_correct: torch.Tensor,
                    l_correct: torch.Tensor, beta: float) -> torch.Tensor:
    """All inputs (N,) bool; returns (N,) float32 costs."""
    off = offloaded.float()
    eta = 1.0 - l_correct.float()
    gamma = 1.0 - s_correct.float()
    return off * (beta + eta) + (1.0 - off) * gamma


def total_cost(offloaded, s_correct, l_correct, beta: float) -> torch.Tensor:
    return per_sample_cost(offloaded, s_correct, l_correct, beta).sum()


def cost_closed_form(n_offloaded: int, n_wrong_local: int, n_wrong_remote: int,
                     beta: float) -> float:
    """The paper's tabulated form: N_off*beta + misclassified."""
    return n_offloaded * beta + n_wrong_local + n_wrong_remote


def relative_cost_reduction(cost_hi: float, cost_ref: float) -> float:
    """Paper's '(1 - HI/ref) x 100%' cost-reduction metric."""
    return (1.0 - cost_hi / cost_ref) * 100.0


@dataclass
class CostReport:
    """One row of the paper's Table 1 / Table 3."""
    approach: str
    n: int
    offloaded: int
    wrong_local: int
    wrong_remote: int
    beta: float

    @property
    def misclassified(self) -> int:
        return self.wrong_local + self.wrong_remote

    @property
    def accuracy(self) -> float:
        return 1.0 - self.misclassified / self.n

    @property
    def cost(self) -> float:
        return cost_closed_form(self.offloaded, self.wrong_local,
                                self.wrong_remote, self.beta)

    def cost_formula(self) -> str:
        return f"{self.offloaded}*beta + {self.misclassified}"

    def row(self) -> Dict[str, object]:
        return {
            "approach": self.approach,
            "offloaded": self.offloaded,
            "offloaded_pct": 100.0 * self.offloaded / self.n,
            "misclassified": self.misclassified,
            "accuracy_pct": 100.0 * self.accuracy,
            "cost": self.cost,
            "cost_formula": self.cost_formula(),
        }
