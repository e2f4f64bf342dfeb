"""Offline theta* calibration (paper §4: brute force over the validation set;
they find theta* = 0.607 for their CIFAR-10 S-ML)."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


def brute_force_theta(conf: np.ndarray, s_correct: np.ndarray,
                      beta: float, l_correct: Optional[np.ndarray] = None,
                      grid: Optional[np.ndarray] = None
                      ) -> Tuple[float, float]:
    """Minimise sum_i C_i(theta) over a grid.  Returns (theta*, min cost).

    conf (N,) in [0,1]; s_correct (N,) bool; l_correct (N,) bool or None
    (None = assume remote always right, eta=0).
    """
    conf = np.asarray(conf, np.float64)
    s_ok = np.asarray(s_correct, bool)
    eta = np.zeros_like(conf) if l_correct is None \
        else 1.0 - np.asarray(l_correct, np.float64)
    if grid is None:
        # candidate thresholds: every observed confidence (plus endpoints) —
        # the cost is piecewise-constant between observed values
        grid = np.unique(np.concatenate([[0.0], conf, [1.0 - 1e-9]]))
    # sort once, sweep cumulative sums
    order = np.argsort(conf)
    cs, es = conf[order], eta[order]
    gs = 1.0 - s_ok[order].astype(np.float64)
    # prefix sums of offloaded-part cost (beta + eta) and suffix of gamma
    pre_off = np.concatenate([[0.0], np.cumsum(beta + es)])
    suf_gam = np.concatenate([np.cumsum(gs[::-1])[::-1], [0.0]])
    idx = np.searchsorted(cs, grid, side="left")
    costs = pre_off[idx] + suf_gam[idx]
    j = int(np.argmin(costs))
    return float(grid[j]), float(costs[j])


def cost_curve(conf: np.ndarray, s_correct: np.ndarray, beta: float,
               l_correct: Optional[np.ndarray] = None,
               thetas: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
    """Total cost as a function of theta (Fig. 6-style analysis)."""
    if thetas is None:
        thetas = np.linspace(0, 1, 101)
    conf = np.asarray(conf)
    s_ok = np.asarray(s_correct, bool)
    eta = np.zeros(len(conf)) if l_correct is None \
        else 1.0 - np.asarray(l_correct, np.float64)
    costs = []
    for th in thetas:
        off = conf < th
        costs.append(np.sum(np.where(off, beta + eta, 1.0 - s_ok)))
    return {"theta": thetas, "cost": np.asarray(costs)}


def p_histogram(conf: np.ndarray, s_correct: np.ndarray, bins: int = 20
                ) -> Dict[str, np.ndarray]:
    """Correct/incorrect counts per confidence bin (paper Fig. 6)."""
    edges = np.linspace(0, 1, bins + 1)
    ok = np.asarray(s_correct, bool)
    h_ok, _ = np.histogram(conf[ok], bins=edges)
    h_bad, _ = np.histogram(conf[~ok], bins=edges)
    return {"edges": edges, "correct": h_ok, "incorrect": h_bad}
