"""Offload decision policies (the HI decision module of Fig. 1).

* :class:`ThresholdPolicy` — the paper's rule: offload iff conf < theta.
* :class:`BinaryRelevancePolicy` — §5 dog-filter rule: offload iff p >= theta.
* :class:`OnlineThresholdPolicy` — Hedge over a grid of thresholds with the
  full-information counterfactual cost (paper ref [27]).  It runs on the host
  on the values the engine fetched, so it is plain numpy.
* :class:`AlwaysOffload` / :class:`NeverOffload` — the full-offload and
  tinyML endpoints.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


class Policy:
    def offload(self, conf: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    name: str = "policy"


@dataclass
class ThresholdPolicy(Policy):
    theta: float = 0.607
    name: str = "hi-threshold"

    def offload(self, conf):
        return conf < self.theta


@dataclass
class BinaryRelevancePolicy(Policy):
    """Offload the samples of interest (conf = P(positive class))."""
    theta: float = 0.5
    name: str = "hi-binary"

    def offload(self, conf):
        return conf >= self.theta


@dataclass
class AlwaysOffload(Policy):
    name: str = "full-offload"

    def offload(self, conf):
        return torch.ones_like(conf, dtype=torch.bool)


@dataclass
class NeverOffload(Policy):
    name: str = "tinyml"

    def offload(self, conf):
        return torch.zeros_like(conf, dtype=torch.bool)


class OnlineThresholdPolicy(Policy):
    """Hedge over a grid of thresholds; full-information counterfactual cost.

    After serving sample i, every candidate theta's cost is known:
    offloading costs ~(beta + E[eta]), accepting costs gamma_i.  Weights
    update multiplicatively; the acting threshold is the weighted median.
    """

    name = "hi-online"

    def __init__(self, beta: float, grid: int = 64, eta_lr: float = 0.15,
                 l_ml_err: float = 0.0):
        self.grid = np.linspace(0.0, 1.0, grid, endpoint=False)
        self.w = np.ones(grid, dtype=np.float64)
        self.beta = beta
        self.eta_lr = eta_lr
        self.l_ml_err = l_ml_err     # expected remote error E[eta]
        self.history: list[float] = []

    @property
    def theta(self) -> float:
        cdf = np.cumsum(self.w / self.w.sum())
        return float(self.grid[int(np.searchsorted(cdf, 0.5))])

    def offload(self, conf):
        return conf < self.theta

    def update(self, conf: np.ndarray, s_correct: np.ndarray) -> None:
        """Batched counterfactual update."""
        conf = np.asarray(conf, np.float64)
        ok = np.asarray(s_correct, np.float64)
        for c, k in zip(conf, ok):
            offload = c < self.grid
            cost = np.where(offload, self.beta + self.l_ml_err, 1.0 - k)
            self.w *= np.exp(-self.eta_lr * cost)
            s = self.w.sum()
            if s < 1e-290:           # renormalise to dodge underflow
                self.w /= s
            self.history.append(self.theta)
