"""Margin-aware comparison of greedy decisions between two implementations.

Parity across frameworks, or between the card and the CPU, is not bitwise:
sums run in another order.  Random-init logits often have their top two
entries within that noise, so a greedy token is compared only where the
reference's top1 - top2 logit margin exceeds the tolerance.

It sits in the package, not beside the tests, because ``chip_smoke.py``
uses it too and finds only ``src/`` on its path.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def decisive(ref_logits: np.ndarray, tol: float) -> np.ndarray:
    """(..., V) -> (...) bool: the reference's argmax is decided by more
    than ``tol``."""
    top2 = np.sort(np.asarray(ref_logits, np.float64), axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) > tol


def greedy_agreement(ref_logits: np.ndarray, got_logits: np.ndarray,
                     tol: float) -> Tuple[int, int]:
    """(decisive positions, of which the two argmaxes agree)."""
    mask = decisive(ref_logits, tol)
    same = np.argmax(ref_logits, -1) == np.argmax(got_logits, -1)
    return int(mask.sum()), int((same & mask).sum())
