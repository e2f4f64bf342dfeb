"""The port's sampler against ``jax.random`` and the reference's sampler.

Keys, bits and uniforms are integer and bit-level arithmetic, so they are
compared bit for bit.  ``gumbel`` takes two logs, which XLA's CPU build and
torch compute to within an ulp or so, so it is compared to 1e-6 relative
(with a floor of 1: the values near 0 differ by a few 1e-8 absolute), at
every position where jax's own value is within that of the float64 gumbel
of the same bit-exact uniform.  (XLA's vectorised log has once, in a run of
this comparison, put one value of 151,936 1e-4 off that float64 value; the
port is held to the float64 value everywhere.)  A sampled token is compared
where the draw is decisive: the top1 - top2 margin of ``logits / t +
gumbel`` exceeds 1e-4, far above the two packages' differences.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import sampler as jsampler
from repro_torch.serving import sampler

SEEDS = np.array([0, 1, 7, 2 ** 31 - 1, 12345, 31], np.int32)
TOKEN_IDX = [0, 1, 3, 17, 2 ** 31 - 1]
SHAPES = [(3,), (2, 5), (1, 151_936)]
GUMBEL_RTOL = 1e-6
MARGIN = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The threefry draws are a few hundred small elementwise ops: on one
    intra-op thread they run several times faster than on a shared
    machine's many, and other test files in the worker keep theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _words(a):
    """jax uint32 words as int64, the port's representation."""
    return np.asarray(a).astype(np.int64)


def _jax_keys(seeds, idx):
    keys = jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds).astype(jnp.uint32))
    return jax.vmap(jax.random.fold_in)(
        keys, jnp.full(seeds.shape, idx, jnp.uint32))


def test_prng_key_and_fold_in_bit_for_bit():
    for s in SEEDS:
        jk = jax.random.PRNGKey(np.uint32(s))
        tk = sampler.prng_key(torch.tensor(int(s)))
        np.testing.assert_array_equal(_words(jk), tk.numpy())
        for i in TOKEN_IDX:
            np.testing.assert_array_equal(
                _words(jax.random.fold_in(jk, i)),
                sampler.fold_in(tk, i).numpy())


@pytest.mark.parametrize("idx", TOKEN_IDX)
def test_request_keys_bit_for_bit(idx):
    tk = sampler.request_keys(torch.from_numpy(SEEDS), idx)
    np.testing.assert_array_equal(_words(_jax_keys(SEEDS, idx)), tk.numpy())
    np.testing.assert_array_equal(
        _words(jsampler.request_keys(jnp.asarray(SEEDS), idx)), tk.numpy())
    # a per-row token index (the scheduler's tok_idx + k) and a tensor index
    per_row = np.arange(len(SEEDS), dtype=np.int32) + idx % 1000
    np.testing.assert_array_equal(
        _words(jsampler.request_keys(jnp.asarray(SEEDS),
                                     jnp.asarray(per_row))),
        sampler.request_keys(torch.from_numpy(SEEDS),
                             torch.from_numpy(per_row)).numpy())


@pytest.mark.parametrize("shape", SHAPES)
def test_random_bits_and_uniform_bit_for_bit(shape):
    keys = _jax_keys(SEEDS[:3], 5)
    tkeys = sampler.request_keys(torch.from_numpy(SEEDS[:3]), 5)
    for r in range(3):
        np.testing.assert_array_equal(
            _words(jax.random.bits(keys[r], shape, jnp.uint32)),
            sampler.random_bits(tkeys[r], shape).numpy())
        np.testing.assert_array_equal(
            np.asarray(jax.random.uniform(keys[r], shape)).view(np.int32),
            sampler.uniform(tkeys[r], shape).numpy().view(np.int32))
    # per-row keys draw each row from its own key
    rows = sampler.random_bits(tkeys, shape)
    assert rows.shape == (3,) + shape
    np.testing.assert_array_equal(
        rows[1].numpy(), _words(jax.random.bits(keys[1], shape, jnp.uint32)))


@pytest.mark.parametrize("shape", SHAPES)
def test_gumbel_within_tolerance(shape):
    for s in SEEDS[:4]:
        jk = jax.random.fold_in(jax.random.PRNGKey(np.uint32(s)), 3)
        tk = sampler.fold_in(sampler.prng_key(torch.tensor(int(s))), 3)
        jg = np.asarray(jax.random.gumbel(jk, shape))
        tg = sampler.gumbel(tk, shape).numpy()
        u = sampler.uniform(tk, shape, minval=sampler.TINY).numpy()
        exact = -np.log(-np.log(u.astype(np.float64)))
        scale = np.maximum(1.0, np.abs(exact))
        assert (np.abs(tg - exact) <= GUMBEL_RTOL * scale).all()
        ok = np.abs(jg - exact) <= GUMBEL_RTOL * scale
        assert ok.mean() >= 0.9999
        assert (np.abs(tg - jg)[ok] <= 2 * GUMBEL_RTOL * scale[ok]).all()


def _decisive(keys_t, logits, temps):
    """Rows whose sampled draw has a top1 - top2 margin over MARGIN."""
    t = np.maximum(np.broadcast_to(temps, (logits.shape[0],)), 1e-6)
    g = sampler.gumbel(keys_t, logits.shape[1:]).numpy()
    z = np.sort(logits / t[:, None] + g, axis=-1)
    return (z[:, -1] - z[:, -2]) > MARGIN


@pytest.mark.parametrize("vocab", [512, 151_936])
def test_sample_matches_the_reference(vocab):
    rng = np.random.default_rng(vocab)
    n = len(SEEDS)
    logits = (rng.normal(size=(n, vocab)) * 3).astype(np.float32)
    jkeys = jsampler.request_keys(jnp.asarray(SEEDS), 4)
    tkeys = sampler.request_keys(torch.from_numpy(SEEDS), 4)
    tl = torch.from_numpy(logits)
    greedy = tl.argmax(-1).numpy()
    temps = np.array([0.7, 0.0, 1.3, -1.0, 0.7, 2.0], np.float32)
    for temp in (0.7, temps):
        jt = np.asarray(jsampler.sample(jkeys, jnp.asarray(logits), temp))
        tt = sampler.sample(tkeys, tl, torch.as_tensor(temp)).numpy()
        dec = _decisive(tkeys, logits, temp)
        assert dec.sum() >= n - 1
        np.testing.assert_array_equal(tt[dec], jt[dec])
        hot = np.broadcast_to(np.asarray(temp) > 0, (n,))
        np.testing.assert_array_equal(tt[~hot], greedy[~hot])
    # a python temp <= 0 is greedy exactly, and draws nothing
    for temp in (0.0, -0.5):
        assert torch.equal(sampler.sample(tkeys, tl, temp), tl.argmax(-1))
        np.testing.assert_array_equal(
            np.asarray(jsampler.sample(jkeys, jnp.asarray(logits), temp)),
            greedy)
    # sampling moves tokens off greedy at a high temperature
    hot = sampler.sample(tkeys, tl, 5.0).numpy()
    assert (hot != greedy).any()


def test_temperature_takes_one_key_for_the_batch():
    logits = np.random.default_rng(2).normal(size=(4, 64)).astype(np.float32)
    jk = jax.random.PRNGKey(9)
    tk = sampler.prng_key(torch.tensor(9))
    jt = np.asarray(jsampler.temperature(jk, jnp.asarray(logits), 0.8))
    tt = sampler.temperature(tk, torch.from_numpy(logits), 0.8).numpy()
    g = sampler.gumbel(tk, logits.shape).numpy()
    z = np.sort(logits / np.float32(0.8) + g, axis=-1)
    dec = (z[:, -1] - z[:, -2]) > MARGIN
    np.testing.assert_array_equal(tt[dec], jt[dec])
    assert dec.sum() >= 3
    np.testing.assert_array_equal(
        sampler.temperature(tk, torch.from_numpy(logits), 0.0).numpy(),
        logits.argmax(-1))


def test_the_cards_words_are_jaxs():
    """chip_smoke.py holds the card's keys and bits to these committed
    words (``SAMPLER_*``): the keys of its (seeds, token index) grid and the
    first and last two bits of each row's (151,936,) draw.  Here they are
    generated again with jax and with the port."""
    import chip_smoke as cs
    seeds = np.asarray(cs.SAMPLER_SEEDS, np.int32)
    idx = np.asarray(cs.SAMPLER_IDX, np.int32)
    jkeys = jax.vmap(jax.random.fold_in)(
        jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds).astype(jnp.uint32)),
        jnp.asarray(idx).astype(jnp.uint32))
    np.testing.assert_array_equal(_words(jkeys), np.asarray(cs.SAMPLER_KEYS))
    tkeys = sampler.request_keys(torch.from_numpy(seeds),
                                 torch.from_numpy(idx))
    np.testing.assert_array_equal(tkeys.numpy(), np.asarray(cs.SAMPLER_KEYS))
    v = cs.SAMPLER_VOCAB
    tbits = sampler.random_bits(tkeys, (v,)).numpy()
    for r in range(len(seeds)):
        jb = _words(jax.random.bits(jkeys[r], (v,), jnp.uint32))
        np.testing.assert_array_equal(tbits[r], jb)
        np.testing.assert_array_equal(
            np.concatenate([jb[:2], jb[-2:]]), cs.SAMPLER_BITS[r])
