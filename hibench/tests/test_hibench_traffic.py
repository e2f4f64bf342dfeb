"""The traffic generator: deterministic under a seed, the same sizes for
every seed in another order, and the lengths and shares of ``chat.json``."""
import json
from pathlib import Path

import numpy as np

from hibench.traffic.generator import Waves

MIX = json.loads((Path(__file__).resolve().parents[1] / "traffic"
                  / "chat.json").read_text())


def _sizes(wave):
    return sorted((len(it.prompt), it.max_new_tokens, it.prefix)
                  for it in wave)


def test_same_seed_same_inputs():
    a, b = Waves(MIX, 32000, 64, 2 ** 31 + 5), Waves(MIX, 32000, 64, 2 ** 31 + 5)
    for i in (0, 3):
        for x, y in zip(a.wave(i), b.wave(i)):
            assert np.array_equal(x.prompt, y.prompt)
            assert x.max_new_tokens == y.max_new_tokens


def test_seeds_share_sizes_not_tokens():
    a, b = Waves(MIX, 32000, 64, 1), Waves(MIX, 32000, 64, 2)
    for i in range(3):
        assert _sizes(a.wave(i)) == _sizes(b.wave(i))
    assert not np.array_equal(a.wave(0)[0].prompt, b.wave(0)[0].prompt) or \
        not np.array_equal(a.wave(0)[1].prompt, b.wave(0)[1].prompt)
    assert _sizes(a.wave(0)) != _sizes(a.wave(1))


def test_lengths_and_shares_follow_the_mix():
    w = Waves(MIX, 32000, 64, 9)
    waves = 32
    items = [it for i in range(waves) for it in w.wave(i)]
    pre = MIX["shared_prefixes"]
    turns = np.array([len(it.prompt) - pre["length"] for it in items])
    new = np.array([it.max_new_tokens for it in items])
    ut, mn = MIX["user_turn"], MIX["max_new_tokens"]
    assert turns.min() >= ut["min"] and turns.max() <= ut["max"]
    assert new.min() >= mn["min"] and new.max() <= mn["max"]
    assert abs(np.median(turns) / ut["median"] - 1) < 0.15
    # one answer length a wave, drawn from the mix's lognormal
    per_wave = new.reshape(waves, 64)
    assert (per_wave == per_wave[:, :1]).all()
    assert abs(np.median(per_wave[:, 0]) / mn["median"] - 1) < 0.3
    shares = np.bincount([it.prefix for it in items],
                         minlength=pre["count"]) / len(items)
    assert np.allclose(shares, pre["weights"], atol=0.04)
    for it in items:
        assert np.array_equal(it.prompt[:pre["length"]],
                              w.prefixes[it.prefix])
        assert it.prompt.min() >= 1 and it.prompt.max() < 32000
        assert it.prompt.dtype == np.int32


def test_warmup_is_apart_and_short():
    w = Waves(MIX, 32000, 64, 3)
    warm = w.warmup()
    assert len(warm) == MIX["warmup"]["requests"]
    assert all(it.max_new_tokens == MIX["warmup"]["max_new_tokens"]
               for it in warm)
    n = MIX["shared_prefixes"]["length"]
    measured = {tuple(it.prompt[n:n + 8]) for i in range(8)
                for it in w.wave(i)}
    assert not any(tuple(it.prompt[n:n + 8]) in measured for it in warm)
