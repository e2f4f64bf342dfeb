"""The benchmark's one traffic generator: closed-loop waves of requests.

A mix file (``traffic/<mix>.json``) holds only parameters:

* ``shared_prefixes``: ``count`` prompts of ``length`` tokens that requests
  start with, picked with ``weights`` (a few clients send most traffic);
* ``user_turn``: the length of the request's own part, lognormal
  (``median``, ``sigma``) clipped to [``min``, ``max``];
* ``max_new_tokens``: lognormal, clipped the same way, drawn once per
  wave: every request of a burst asks for an answer of one length, as
  one edge application's burst shares its ``max_tokens`` setting (the
  random weights emit no end token, so every answer runs to its cap);
* ``size_seed``: the sizes of wave ``i`` (prefix pick, turn length, new
  tokens) are drawn from ``size_seed`` and ``i`` alone;
* ``warmup``: the size of the one short wave that set-up serves.

The run's seed decides the token ids (the shared prefixes' and each
turn's) and the order of the requests inside each wave.  So every seed
serves the same sizes, wave by wave, in another order: the seed changes
the inputs, not the amount of work.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np


@dataclass(frozen=True)
class Item:
    """One request as the traffic makes it."""
    prompt: np.ndarray          # (len,) int32, ids in [1, vocab)
    max_new_tokens: int
    prefix: int                 # index of its shared prefix, -1 for none


def lognormal_sizes(rng: np.random.Generator, spec: dict, n: int) -> np.ndarray:
    """``n`` lognormal integers with the spec's median and sigma, clipped."""
    x = spec["median"] * np.exp(spec["sigma"] * rng.standard_normal(n))
    return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)


def size_set(mix: dict, wave_requests: int, key: int,
             new_tokens: int = None):
    """(prefix index, turn length, max new tokens) per request of the wave
    drawn under ``key``: fixed by the mix, whatever the run's seed.  The
    answer length is one a wave, or ``new_tokens`` where given."""
    rng = np.random.default_rng([mix["size_seed"], key])
    pre = mix["shared_prefixes"]
    w = np.asarray(pre["weights"], np.float64)
    prefix = rng.choice(pre["count"], size=wave_requests, p=w / w.sum())
    turn = lognormal_sizes(rng, mix["user_turn"], wave_requests)
    if new_tokens is None:
        new_tokens = lognormal_sizes(rng, mix["max_new_tokens"], 1)[0]
    return prefix, turn, np.full(wave_requests, new_tokens, np.int64)


# the warm-up's size key, apart from every measured wave's index
WARMUP_KEY = 2 ** 32 - 1


class Waves:
    """The waves of one run: ``wave(i)`` is the i-th measured wave,
    ``warmup()`` set-up's wave, drawn apart from them."""

    def __init__(self, mix: dict, vocab: int, wave_requests: int, seed: int):
        if mix.get("kind") != "waves":
            raise ValueError(f"unknown traffic kind {mix.get('kind')!r}")
        self.mix = mix
        self.vocab = vocab
        self.wave_requests = wave_requests
        self.seed = seed
        pre = mix["shared_prefixes"]
        rng = np.random.default_rng([seed, 0x5EED, 0])
        self.prefixes = [self._ids(rng, pre["length"])
                         for _ in range(pre["count"])]

    def _ids(self, rng: np.random.Generator, n: int) -> np.ndarray:
        return rng.integers(1, self.vocab, size=n, dtype=np.int64).astype(
            np.int32)

    def _items(self, rng, prefix, turn, new) -> List[Item]:
        out = []
        for p, t, m in zip(prefix, turn, new):
            head = self.prefixes[p] if p >= 0 else np.zeros(0, np.int32)
            out.append(Item(np.concatenate([head, self._ids(rng, int(t))]),
                            int(m), int(p)))
        return out

    def wave(self, i: int) -> List[Item]:
        prefix, turn, new = size_set(self.mix, self.wave_requests, i)
        rng = np.random.default_rng([self.seed, 0x5EED, 1, i])
        order = rng.permutation(self.wave_requests)
        return self._items(rng, prefix[order], turn[order], new[order])

    def warmup(self) -> List[Item]:
        spec = self.mix["warmup"]
        n = spec["requests"]
        prefix, turn, new = size_set(self.mix, n, WARMUP_KEY,
                                     spec["max_new_tokens"])
        rng = np.random.default_rng([self.seed, 0x5EED, 2])
        return self._items(rng, prefix, turn, new)
