"""The port's legacy baseline (``HIEngine.serve_legacy``) and temperature
sampling on ``serve`` and ``serve_stream``, on reduced qwen2-1.5b.

* ``tests/test_prefill_serving.py``'s ``test_engine_matches_legacy_serve``
  and ``tests/test_scheduler.py``'s ``test_stream_temperature_matches_drain``
  re-stated on the port;
* the port's ``serve_legacy`` against the reference's, and its sampled
  ``serve`` / ``serve_stream`` against the reference's, on bridged params;
* one ``_host_fetch`` per tick when sampled; speculative + temperature
  still raises; the CLI's ``--legacy`` and ``--temperature``.

Tolerances.  The reference's batched prefill and per-token decode give the
same bits on its CPU build; the port's float32 products of (B, S) and
(B, 1) rows sum in different orders, and a K or V element that lands on the
other side of a bf16 rounding moves the logits by up to ~1e-2 at this size.
So the port's legacy and drain paths are compared as the port is compared
with the reference: greedy tokens teacher-forced, where the top1 - top2
margin exceeds ``LOGIT_TOL``, and mean confidences to ``CONF_TOL`` (the
tolerances of ``tests/test_torch_engine.py``).  A sampled token is compared
where the draw is decisive: the margin of ``logits / t + gumbel`` (the
gumbel of the token's bit-exact key) exceeds ``2 * LOGIT_TOL / t``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import HIConfig as JHIConfig
from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.serving.batcher import Request as JRequest
from repro.serving.engine import build_engine as jax_build_engine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import HIConfig
from repro_torch.configs.registry import ARCHS
from repro_torch.kernels import ops
from repro_torch.models import model_zoo as tzoo
from repro_torch.parity import decisive
from repro_torch.serving import engine as engine_mod
from repro_torch.serving import sampler
from repro_torch.serving.batcher import Request
from repro_torch.serving.engine import HIEngine, TierModel, build_engine
from test_torch_engine import _teacher_forced

ARCH = "qwen2-1.5b"
T, CACHE = 4, 32
LOGIT_TOL = 5e-3
CONF_TOL = 1e-4
TEMP = 0.7


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The threefry draws are a few hundred small elementwise ops: on one
    intra-op thread they run several times faster than on a shared
    machine's many, and other test files in the worker keep theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    return ARCHS[ARCH].reduced()


def _prompts(seed=5, b=4, s=8):
    return np.random.default_rng(seed).integers(
        0, _cfg().vocab_size, (b, s)).astype(np.int32)


def _port_logits(tier, prompts, toks):
    """The port's contiguous-path logits along ``toks``: (T, B, V)."""
    b = prompts.shape[0]
    lg, cache = tzoo.prefill(tier.params, tier.cfg,
                             torch.as_tensor(prompts, dtype=torch.int64),
                             tzoo.init_cache(tier.cfg, b, CACHE,
                                             device="cpu"))
    out = []
    for i in range(toks.shape[1]):
        out.append(lg.numpy())
        lg, cache = tzoo.decode_step(
            tier.params, tier.cfg,
            torch.as_tensor(toks[:, i:i + 1], dtype=torch.int64), cache)
    return np.stack(out)


def _first_undecided(logits_tbv, tol):
    """Per row, the first step whose margin is under ``tol`` (T if none)."""
    dec = decisive(logits_tbv, tol)                       # (T, B)
    return np.where(dec.all(0), dec.shape[0], np.argmin(dec, 0))


def _assert_tokens(ref, got, logits_tbv, tol):
    first = _first_undecided(logits_tbv, tol)
    for r, n in enumerate(first):
        np.testing.assert_array_equal(got[r, :n], ref[r, :n])
    return int(first.sum())


def test_engine_matches_legacy_serve():
    """tests/test_prefill_serving.py:139 on the port: the drained cascade
    and the legacy path agree on generations, confidence and offloads."""
    hi = HIConfig(theta=0.6, capacity_factor=0.5)
    toks = _prompts()
    eng = build_engine(_cfg(), hi, max_new_tokens=T, cache_len=CACHE,
                       device="cpu")
    new = eng.serve(toks)
    old = eng.serve_legacy(toks)
    assert set(old) == set(new)
    assert old["tokens"].dtype == new["tokens"].dtype == np.int32
    n = _assert_tokens(old["s_tokens"], new["s_tokens"],
                       _port_logits(eng.s, toks, old["s_tokens"]), LOGIT_TOL)
    assert n >= T * len(toks) // 2
    np.testing.assert_array_equal(new["offloaded"], old["offloaded"])
    np.testing.assert_array_equal(new["served_remote"], old["served_remote"])
    np.testing.assert_allclose(new["confidence"], old["confidence"],
                               rtol=CONF_TOL, atol=CONF_TOL)
    served = np.flatnonzero(old["served_remote"])
    _assert_tokens(old["tokens"][served], new["tokens"][served],
                   _port_logits(eng.l, toks[served], old["tokens"][served]),
                   LOGIT_TOL)
    local = ~old["served_remote"]
    np.testing.assert_array_equal(old["tokens"][local],
                                  old["s_tokens"][local])
    assert eng.stats["requests"] == 2 * len(toks)


def test_legacy_takes_no_kernel_launch_on_the_cpu():
    """The legacy path's confidence is the plain metric: no hi_gate call,
    and on the CPU no kernel counter moves."""
    eng = build_engine(_cfg(), HIConfig(theta=0.6), max_new_tokens=2,
                       cache_len=CACHE, device="cpu")
    ops.reset_launch_counts()
    eng.serve_legacy(_prompts(b=2))
    assert set(ops.launch_counts().values()) == {0}


@pytest.fixture(scope="module")
def bridged():
    """The reference's engine (temperature 0.7, plain path) and the port's
    on the same params, theta 0.6, capacity 0.5."""
    jcfg, tcfg = JAX_ARCHS[ARCH].reduced(), _cfg()
    jeng = jax_build_engine(jcfg, JHIConfig(theta=0.6, capacity_factor=0.5),
                            max_new_tokens=T, cache_len=CACHE,
                            temperature=TEMP)
    tiers = [TierModel(c, params_from_numpy(jax.tree.map(np.asarray,
                                                         t.params),
                                            device="cpu"))
             for c, t in ((tcfg.s_variant(4), jeng.s), (tcfg, jeng.l))]
    teng = HIEngine(*tiers, HIConfig(theta=0.6, capacity_factor=0.5),
                    cache_len=CACHE, max_new_tokens=T, temperature=TEMP)
    return jeng, teng


def test_legacy_matches_the_reference(bridged):
    jeng, teng = bridged
    toks = _prompts(seed=6)
    jout, tout = jeng.serve_legacy(toks), teng.serve_legacy(toks)
    js, ts = _teacher_forced(jeng.s.cfg, jeng.s.params, teng.s.cfg,
                             teng.s.params, toks, jout["s_tokens"])
    np.testing.assert_allclose(ts, js, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    assert _assert_tokens(jout["s_tokens"], tout["s_tokens"], js,
                          2 * LOGIT_TOL) > 0
    row_ok = decisive(js, 2 * LOGIT_TOL).all(axis=0)
    np.testing.assert_allclose(tout["confidence"][row_ok],
                               jout["confidence"][row_ok],
                               rtol=CONF_TOL, atol=CONF_TOL)
    far = row_ok & (np.abs(jout["confidence"] - 0.6) > CONF_TOL)
    np.testing.assert_array_equal(tout["offloaded"][far],
                                  jout["offloaded"][far])


def _sampled_margin_ok(logits_tbv, seeds, temp, tol):
    """(T, B) bool: step i's draw ``argmax(logits / t + gumbel)`` under
    ``request_keys(seeds, i)`` is decided by more than ``tol``; and the
    draws along the logits (T, B)."""
    t_steps, _, v = logits_tbv.shape
    dec, draws = [], []
    for i in range(t_steps):
        keys = sampler.request_keys(torch.as_tensor(seeds), i)
        z = logits_tbv[i] / np.float32(temp) + \
            sampler.gumbel(keys, (v,)).numpy()
        top2 = np.sort(z.astype(np.float64), -1)[:, -2:]
        dec.append(top2[:, 1] - top2[:, 0] > tol)
        draws.append(z.argmax(-1))
    return np.stack(dec), np.stack(draws)


def _assert_sampled(ref, got, logits_tbv, seeds):
    dec, draws = _sampled_margin_ok(logits_tbv, seeds, TEMP,
                                    2 * LOGIT_TOL / TEMP)
    # the reference's own tokens are these draws where decided
    np.testing.assert_array_equal(np.where(dec, draws, 0).T,
                                  np.where(dec, ref.T, 0).T)
    first = np.where(dec.all(0), dec.shape[0], np.argmin(dec, 0))
    for r, n in enumerate(first):
        np.testing.assert_array_equal(got[r, :n], ref[r, :n])
    return int(first.sum())


def test_sampled_serve_matches_the_reference(bridged):
    jeng, teng = bridged
    toks = _prompts(seed=7)
    seeds = np.array([11, 3, 2 ** 31 - 1, 0], np.int32)
    old = dataclasses.replace(jeng.hi)
    try:
        # theta 0: S tokens only, every row decided on the S tier
        jeng.hi = dataclasses.replace(old, theta=0.0)
        teng.hi = dataclasses.replace(teng.hi, theta=0.0)
        jout = jeng.serve(toks, seeds=seeds)
        tout = teng.serve(toks, seeds=seeds)
    finally:
        jeng.hi = old
        teng.hi = dataclasses.replace(teng.hi, theta=0.6)
    js, _ = _teacher_forced(jeng.s.cfg, jeng.s.params, teng.s.cfg,
                            teng.s.params, toks, jout["s_tokens"])
    assert _assert_sampled(jout["s_tokens"], tout["s_tokens"], js,
                           seeds) >= T * len(toks) // 2
    greedy = js.argmax(-1).T
    assert (greedy != jout["s_tokens"]).any()


def _temp_requests(lens, seed=5, temperature=TEMP):
    rng = np.random.default_rng(seed)
    return [Request(i, rng.integers(0, _cfg().vocab_size, n).astype(np.int32),
                    max_new_tokens=3, temperature=temperature)
            for i, n in enumerate(lens)]


def _drain_by_bucket(eng, reqs):
    out = {}
    for n in sorted({len(r.prompt) for r in reqs}):
        sub = [r for r in reqs if len(r.prompt) == n]
        res = eng.serve(np.stack([r.prompt for r in sub]),
                        seeds=np.asarray([r.request_id for r in sub],
                                         np.int32))
        for j, r in enumerate(sub):
            out[r.request_id] = {k: res[k][j] for k in res}
    return out


def _s_only_engine(temperature=0.0, seed=0):
    return build_engine(_cfg(), HIConfig(theta=0.0, capacity_factor=1.0),
                        seed=seed, max_new_tokens=3, cache_len=CACHE,
                        device="cpu", temperature=temperature)


def test_stream_temperature_matches_drain():
    """tests/test_scheduler.py:80 on the port: keys depend only on the
    request id and the token index, not on slot, tick or batch row."""
    reqs = _temp_requests([8, 8, 16])
    drain = _drain_by_bucket(_s_only_engine(TEMP), reqs)
    stream = _s_only_engine().serve_stream(reqs, buckets=(8, 16),
                                           num_slots=2, page_size=8)
    for rid, rec in stream.items():
        np.testing.assert_array_equal(rec["tokens"], drain[rid]["tokens"])
    greedy = _drain_by_bucket(_s_only_engine(), reqs)
    assert any(not np.array_equal(greedy[r]["tokens"], drain[r]["tokens"])
               for r in drain)


def test_sampled_stream_is_reproducible_across_lanes(monkeypatch):
    """A sampled stream through the admit, chunk and decode lanes, with
    prefix sharing: the engine's temperature for requests that set none,
    the same tokens on a second run and with chunking off, and one
    ``_host_fetch`` per tick."""
    calls = []
    real = engine_mod._host_fetch
    monkeypatch.setattr(engine_mod, "_host_fetch",
                        lambda tree: (calls.append(1), real(tree))[1])
    reqs = _temp_requests([8, 16, 8, 16, 16], seed=9, temperature=0.0)
    reqs.append(Request(9, reqs[1].prompt, max_new_tokens=3))
    kw = dict(buckets=(8, 16), num_slots=2, page_size=8)
    eng = _s_only_engine(TEMP)
    a = eng.serve_stream(reqs, chunk_prefill=True, chunk_size=8, **kw)
    assert len(calls) == eng.stats["stream_ticks"] > 0
    assert eng._stream[1].srt.lane_ticks["chunk"] > 0
    b = _s_only_engine(TEMP).serve_stream(reqs, **kw)
    c = _s_only_engine(TEMP).serve_stream(reqs, chunk_prefill=True,
                                          chunk_size=8, **kw)
    drain = _drain_by_bucket(_s_only_engine(TEMP), reqs)
    greedy = _s_only_engine().serve_stream(reqs, **kw)
    for rid in a:
        for other in (b, c):
            np.testing.assert_array_equal(a[rid]["tokens"],
                                          other[rid]["tokens"])
        np.testing.assert_array_equal(a[rid]["tokens"], drain[rid]["tokens"])
    assert any(not np.array_equal(a[r]["tokens"], greedy[r]["tokens"])
               for r in a)


def test_sampled_stream_matches_the_reference():
    """The port's sampled serve_stream against the reference's on bridged
    params, theta 0 (S tokens), per request by the sampled margin rule."""
    jcfg, tcfg = JAX_ARCHS[ARCH].reduced(), _cfg()
    jeng = jax_build_engine(jcfg, JHIConfig(theta=0.0, capacity_factor=1.0),
                            max_new_tokens=3, cache_len=CACHE,
                            temperature=TEMP)
    tiers = [TierModel(c, params_from_numpy(jax.tree.map(np.asarray,
                                                         t.params),
                                            device="cpu"))
             for c, t in ((tcfg.s_variant(4), jeng.s), (tcfg, jeng.l))]
    teng = HIEngine(*tiers, HIConfig(theta=0.0, capacity_factor=1.0),
                    cache_len=CACHE, max_new_tokens=3, temperature=TEMP)
    reqs = _temp_requests([8, 16, 8], seed=4, temperature=0.0)
    kw = dict(buckets=(8, 16), num_slots=2, page_size=8)
    jout = jeng.serve_stream([JRequest(r.request_id, r.prompt,
                                       max_new_tokens=3) for r in reqs], **kw)
    tout = teng.serve_stream(reqs, **kw)
    n = 0
    for r in reqs:
        ref = np.asarray(jout[r.request_id]["s_tokens"])[None]
        js, _ = _teacher_forced(jeng.s.cfg, jeng.s.params, teng.s.cfg,
                                teng.s.params, r.prompt[None], ref)
        n += _assert_sampled(ref, np.asarray(tout[r.request_id]["s_tokens"])
                             [None], js, np.asarray([r.request_id], np.int32))
    assert n >= 4


def test_speculative_with_temperature_still_raises():
    reqs = [Request(0, np.arange(8, dtype=np.int32), max_new_tokens=2)]
    kw = dict(buckets=(8,), num_slots=2, page_size=8, speculative=True)
    with pytest.raises(NotImplementedError, match="greedy-only"):
        _s_only_engine(TEMP).serve_stream(reqs, **kw)
    hot = [Request(0, np.arange(8, dtype=np.int32), temperature=0.5)]
    with pytest.raises(NotImplementedError, match="greedy-only"):
        _s_only_engine().serve_stream(hot, **kw)


@pytest.mark.parametrize("flags", [["--legacy"], ["--temperature", "0.7"]])
def test_cli_legacy_and_temperature(monkeypatch, capsys, flags):
    from repro_torch.launch import serve as serve_cli
    monkeypatch.setattr("sys.argv", ["serve", "--arch", ARCH, "--device",
                                     "cpu", "--requests", "4", "--batch",
                                     "2", "--max-new-tokens", "2"] + flags)
    serve_cli.main()
    out = capsys.readouterr().out
    assert "served 4 requests" in out and "on cpu" in out
