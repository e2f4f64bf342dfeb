"""Synthetic LM token streams (zipf-distributed with short-range structure)
for the training loop's tests and the end-to-end driver: the reference's
``data/tokens.py``, numpy only, the same numbers from the same seed."""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


def token_stream(vocab: int, seed: int = 0) -> np.random.Generator:
    return np.random.default_rng(seed)


def sample_tokens(rng: np.random.Generator, batch: int, seq: int,
                  vocab: int) -> np.ndarray:
    """Zipf marginal + local repetition structure (so loss can fall)."""
    z = rng.zipf(1.3, size=(batch, seq)).astype(np.int64)
    toks = (z - 1) % vocab
    # inject learnable bigram structure: even positions predict the next
    n_pairs = seq // 2
    toks[:, 1:2 * n_pairs:2] = (toks[:, 0:2 * n_pairs:2] * 7 + 13) % vocab
    return toks.astype(np.int32)


def lm_batches(vocab: int, batch: int, seq: int, steps: int,
               seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    rng = token_stream(vocab, seed)
    for _ in range(steps):
        toks = sample_tokens(rng, batch, seq + 1, vocab)
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
