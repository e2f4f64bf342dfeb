"""CIFAR-10 stand-in: synthetic class-conditional 32x32x3 images (paper §4–5).

CIFAR-10 is not available offline, so the generator is engineered to mirror
the paper's *S/L accuracy structure* rather than its pixels:

* a WEAK GLOBAL cue — a class tint on a colour circle with angular jitter —
  whose Bayes accuracy is ~62% (tunable via ``tint_sigma``).  A tinyML-sized
  CNN learns this quickly, landing near the paper's S-ML (62.58%).
* a STRONG LOCAL cue — a class-specific texture-patch pair at mildly
  jittered positions — that needs more depth/capacity to exploit; the deeper
  L-CNN combines both cues and lands near the paper's L-ML (95%).

Crucially, S-ML *confidence* correlates with correctness (samples whose tint
lands near a class boundary are genuinely ambiguous to the S-tier), which is
the property HI's threshold rule exploits (paper Fig. 6).

Class 5 ("dog") doubles as the class-of-interest for the §5 binary filter.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

NUM_CLASSES = 10
DOG_CLASS = 5
_PATCH = 12
IMG = 32

# the strong cue is COMPOSITIONAL: 5 shared blocky base patterns; class c is
# the unordered pair PAIRS[c] of two of them, each placed at a fully random
# position.  Classification requires a conjunction of two translation-
# invariant detections — easy for the global-pooled L-CNN, out of reach for
# the flatten-head tinyML S-ML (calibrated: S~80%, L~94%).
from itertools import combinations
PAIRS = tuple(combinations(range(5), 2))          # exactly 10 classes


def _patterns(seed: int = 1234) -> np.ndarray:
    rng = np.random.default_rng(seed)
    base = rng.normal(0, 1, size=(5, 3, 3, 3))    # low-frequency (blocky)
    p = np.repeat(np.repeat(base, 4, axis=1), 4, axis=2)   # (5, 12, 12, 3)
    return (p / np.abs(p).max(axis=(1, 2, 3), keepdims=True)).astype(np.float32)


def make_dataset(n: int, seed: int = 0, noise: float = 0.40,
                 tint_sigma: float = 0.357, tint_amp: float = 0.5,
                 patch_amp: float = 0.5) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (images (n,32,32,3) float32, labels (n,) int32).

    ``tint_sigma`` = 0.357 puts the tint-only Bayes accuracy at ~62%
    (P(|N(0,s)| < pi/10)).  With ``patch_amp=0.5`` the measured tiers land at
    S ~ 80%, L ~ 94% (vs the paper's 62.58%/95% — the *structure* matches:
    a large S/L gap with confidence-correlated S errors; the paper's exact
    counts are replayed separately by core/replay).
    """
    rng = np.random.default_rng(seed)
    prims = _patterns()
    labels = rng.integers(0, NUM_CLASSES, size=n).astype(np.int32)
    imgs = rng.normal(0, noise, size=(n, IMG, IMG, 3)).astype(np.float32)

    # weak global cue: tint direction on a colour circle + angular jitter
    angles = 2 * np.pi * labels / NUM_CLASSES \
        + rng.normal(0, tint_sigma, size=n)
    tint = np.stack([np.cos(angles), np.sin(angles),
                     np.zeros_like(angles)], axis=-1).astype(np.float32)
    imgs += tint_amp * tint[:, None, None, :]

    # strong local cue: the class's pattern PAIR at fully random positions
    for i in range(n):
        for p in PAIRS[labels[i]]:
            y, x = rng.integers(0, IMG - _PATCH, 2)
            imgs[i, y:y + _PATCH, x:x + _PATCH] += patch_amp * prims[p]
    return imgs, labels


def binary_labels(labels: np.ndarray, cls: int = DOG_CLASS) -> np.ndarray:
    """Dog / not-dog labels for the §5 relevance filter."""
    return (labels == cls).astype(np.int32)
