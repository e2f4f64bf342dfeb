"""Continuous serving (``HIEngine.serve_stream``) of the port's SSM (mamba2)
and hybrid (zamba2) families on the CPU, at reduced size.

* Against the reference's ``serve_stream`` (``use_kernel=False``) on
  bridged params, with prefix sharing and the chunk lane on: statuses, and
  each request's greedy tokens teacher-forced along the reference's
  contiguous path.
* The reference's invariants re-stated for both families: stream == drain
  (``tests/test_scheduler.py:36``), sharing on == off
  (``tests/test_prefix_cache.py:51``; whole prompts only, no partial hits),
  chunk on == off (``tests/test_chunk_lane.py:139``), one ``_host_fetch``
  per tick, ``check_invariants`` after every tick and no held slot after
  the drain.

Teacher forcing.  Both packages' contiguous-path logits along the port's
stream tokens must agree within ``LOGIT_TOL``, and the port's tokens must
be the reference's greedy path up to the first position whose reference
top1 - top2 margin is not above twice that.  The two streams' S-tier
tokens must agree over the same prefix for the prompts that take the admit
lane.  Prompts that take the chunk lane, and the L tier, are held against
the reference's contiguous path only, not against its stream: the
reference's chunk lane starts a prompt in a reused slot from that slot's
stale recurrent state (ROADMAP Queue C), which on this trace moves a
decisive token (request 7 takes 398 in a reused slot, 269 with a slot of
its own or with the chunk lane off, as the port gives), where the port
starts a prompt from a zero state, as a prefill does.

Tolerances: ``LOGIT_TOL`` = 1e-2 (the hybrid's decode attention keeps q in
float32 where the reference's plain path rounds it to bf16, 1.6e-3 at this
size; mamba2 agrees to 1e-4); ``CONF_TOL`` = 1e-4 on mean confidences
between the port's own chunk-lane and prefill paths (float32 sums in
another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import HIConfig as JHIConfig
from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.models import model_zoo as jzoo
from repro.serving.batcher import Request as JRequest
from repro.serving.engine import build_engine as jax_build_engine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import HIConfig
from repro_torch.configs.registry import ARCHS
from repro_torch.kernels import ops
from repro_torch.models import model_zoo as tzoo
from repro_torch.parity import decisive
from repro_torch.serving import engine as engine_mod
from repro_torch.serving.batcher import Request, pad_to_bucket
from repro_torch.serving.engine import HIEngine, TierModel, build_engine
from repro_torch.serving.faults import STATUSES

LOGIT_TOL = 1e-2
CONF_TOL = 1e-4
STEPS = 3
ARCH_NAMES = ["mamba2-370m", "zamba2-2.7b"]
# repeats of whole prompts in the 12 bucket (a partial tail page of 8: the
# hybrid's restores copy it) take the admit lane; prompts of 13-24 tokens
# take the chunk lane (chunk_size 12)
TRACE_KW = dict(buckets=(12, 16, 24), num_slots=3, l_slots=2, page_size=8,
                decode_block=2, chunk_prefill=True, chunk_size=12)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op torch thread: the reduced models' small ops run about
    as fast on it, and the suite's other workers keep their cores (the
    thread count is restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trace(vocab, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, vocab, 10).astype(np.int32)
    out = []
    for i in range(10):
        if i % 2 == 0:
            p = base if i % 4 == 0 else np.concatenate([base, [5, 6]])
        else:
            p = rng.integers(0, vocab, int(rng.integers(9, 25))) \
                .astype(np.int32)
        out.append((i, p.astype(np.int32)))
    return out


_JIT = {}


def _jax_fns(cfg):
    if cfg not in _JIT:
        _JIT[cfg] = (jax.jit(lambda p, t, c: jzoo.prefill(p, cfg, t, c)),
                     jax.jit(lambda p, t, c: jzoo.decode_step(p, cfg, t, c)))
    return _JIT[cfg]


def _teacher_forced(jtier, ttier, prompt, toks, cache_len):
    """Both packages' contiguous-path logits along ``toks``: (n, V) each."""
    prefill, decode = _jax_fns(jtier.cfg)
    jl, jc = prefill(jtier.params, jnp.asarray(prompt[None]),
                     jzoo.init_cache(jtier.cfg, 1, cache_len))
    tl, tc = tzoo.prefill(ttier.params, ttier.cfg,
                          torch.as_tensor(prompt[None]).long(),
                          tzoo.init_cache(ttier.cfg, 1, cache_len,
                                          device="cpu"))
    js, ts = [np.asarray(jl[0])], [tl[0].numpy()]
    for t in toks[:-1]:
        tok = np.array([[t]], np.int32)
        jl, jc = decode(jtier.params, jnp.asarray(tok), jc)
        tl, tc = tzoo.decode_step(ttier.params, ttier.cfg,
                                  torch.as_tensor(tok).long(), tc)
        js.append(np.asarray(jl[0]))
        ts.append(tl[0].numpy())
    return np.stack(js), np.stack(ts)


def _check_tokens(jtier, ttier, prompt, toks, cache_len):
    """Teacher-forced along the port's stream tokens ``toks``: both
    packages' contiguous logits agree, and ``toks`` is the reference's
    greedy path up to its first position that is not decisive.  Returns
    that position."""
    js, ts = _teacher_forced(jtier, ttier, prompt, toks, cache_len)
    np.testing.assert_allclose(ts, js, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    dec = decisive(js, 2 * LOGIT_TOL)
    first = int(np.argmin(dec)) if not dec.all() else len(dec)
    np.testing.assert_array_equal(toks[:first], js.argmax(-1)[:first])
    return first


@pytest.fixture(scope="module", params=ARCH_NAMES)
def engines(request):
    name = request.param
    jcfg, tcfg = JAX_ARCHS[name].reduced(), ARCHS[name].reduced()
    hi = dict(theta=0.6, capacity_factor=1.0)
    jeng = jax_build_engine(jcfg, JHIConfig(**hi), max_new_tokens=STEPS,
                            cache_len=32)
    tiers = [TierModel(c, params_from_numpy(jax.tree.map(np.asarray,
                                                         t.params),
                                            device="cpu"))
             for c, t in ((tcfg.s_variant(4), jeng.s), (tcfg, jeng.l))]
    teng = HIEngine(*tiers, HIConfig(**hi), max_new_tokens=STEPS)
    return jeng, teng


def test_serve_stream_matches_reference(engines):
    """At theta 0.6 and at the reference's median S confidence; the second
    call finds both packages' prefix caches warm."""
    jeng, teng = engines
    trace = _trace(teng.s.cfg.vocab_size)
    jreqs = [JRequest(i, p, max_new_tokens=STEPS) for i, p in trace]
    treqs = [Request(i, p, max_new_tokens=STEPS) for i, p in trace]
    cache_len = max(TRACE_KW["buckets"]) + STEPS
    compared = same = 0
    th = 0.6
    for _ in range(2):
        jeng.hi = dataclasses.replace(jeng.hi, theta=th)
        teng.hi = dataclasses.replace(teng.hi, theta=th)
        jout = jeng.serve_stream(jreqs, **TRACE_KW)
        tout = teng.serve_stream(treqs, validate=True, **TRACE_KW)
        assert set(tout) == set(jout) == {i for i, _ in trace}
        sched = teng._stream[1]
        assert sched.srt.pool.held_slots == sched.lrt.pool.held_slots == []
        for i, p in trace:
            j, t = jout[i], tout[i]
            assert t["status"] == j["status"] and t["status"] in STATUSES
            prompt = np.zeros(pad_to_bucket(len(p), TRACE_KW["buckets"]),
                              np.int32)
            prompt[: len(p)] = p
            first = _check_tokens(jeng.s, teng.s, prompt, t["s_tokens"],
                                  cache_len)
            if len(prompt) <= TRACE_KW["chunk_size"]:     # the admit lane
                np.testing.assert_array_equal(j["s_tokens"][:first],
                                              t["s_tokens"][:first])
                same += 1
            compared += first
            if t["served_remote"]:
                compared += _check_tokens(jeng.l, teng.l, prompt,
                                          t["tokens"], cache_len)
        th = float(np.median([rec["confidence"] for rec in jout.values()]))
    assert compared > 0 and same > 0
    stats = teng._stream[1].prefix_stats
    assert stats["full_hits"] > 0
    assert stats["hits"] == stats["full_hits"]       # whole prompts only
    assert teng.stats["stream_compiles"] == 1


# ---------------------------------------------------------------------------
# the reference's invariants, re-stated for the recurrent families
# ---------------------------------------------------------------------------

def _engine(name, theta=0.6, cache_len=48):
    return build_engine(ARCHS[name].reduced(),
                        HIConfig(theta=theta, capacity_factor=1.0),
                        max_new_tokens=STEPS, cache_len=cache_len,
                        device="cpu")


def _requests(name, lens, seed):
    vocab = ARCHS[name].reduced().vocab_size
    rng = np.random.default_rng(seed)
    return [Request(i, rng.integers(0, vocab, n).astype(np.int32),
                    max_new_tokens=STEPS) for i, n in enumerate(lens)]


def _assert_stream_equal(a, b, conf_tol=1e-6):
    assert set(a) == set(b)
    for rid in b:
        np.testing.assert_array_equal(a[rid]["tokens"], b[rid]["tokens"])
        np.testing.assert_array_equal(a[rid]["s_tokens"], b[rid]["s_tokens"])
        assert a[rid]["offloaded"] == b[rid]["offloaded"]
        assert a[rid]["served_remote"] == b[rid]["served_remote"]
        assert a[rid]["status"] == b[rid]["status"]
        assert abs(a[rid]["confidence"] - b[rid]["confidence"]) <= conf_tol


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_stream_matches_drain_on_mixed_lengths(name):
    """tests/test_scheduler.py:36 — the prompt's padding is part of the
    bucketized prompt on both paths, so the recurrent state matches."""
    reqs = _requests(name, [8, 16, 8, 16, 8], seed=7)
    drain = {}
    eng = _engine(name)
    for n in (8, 16):
        sub = [r for r in reqs if len(r.prompt) == n]
        res = eng.serve(np.stack([r.prompt for r in sub]))
        for j, r in enumerate(sub):
            drain[r.request_id] = {k: res[k][j] for k in res}
    eng = _engine(name)
    stream = eng.serve_stream(reqs, buckets=(8, 16), num_slots=3,
                              page_size=8, validate=True)
    for rid, rec in stream.items():
        np.testing.assert_array_equal(rec["tokens"], drain[rid]["tokens"])
        np.testing.assert_array_equal(rec["s_tokens"], drain[rid]["s_tokens"])
        assert rec["offloaded"] == bool(drain[rid]["offloaded"])
        np.testing.assert_allclose(rec["confidence"],
                                   drain[rid]["confidence"], atol=1e-5)


def _repeated_prompts(name, seed=3):
    vocab = ARCHS[name].reduced().vocab_size
    rng = np.random.default_rng(seed)
    base = rng.integers(0, vocab, 8).astype(np.int32)

    def mk(n):
        return np.concatenate([base, rng.integers(0, vocab, n)
                               .astype(np.int32)])

    p1, p2, p3 = mk(4), mk(8), mk(8)
    return [Request(i, p, max_new_tokens=STEPS)
            for i, p in enumerate([p1, p2, p3, p1, p2, p3, p1, p2])]


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_sharing_equivalence(name):
    """tests/test_prefix_cache.py:51 — sharing on == off token for token;
    the recurrent families restore whole prompts (state snapshot, and for
    the hybrid aliased pages with a copy-on-write tail) and take no partial
    hit."""
    reqs = _repeated_prompts(name)
    kw = dict(buckets=(12, 16), num_slots=2, page_size=8, validate=True)
    eng_on = _engine(name)
    on = eng_on.serve_stream(reqs, prefix_sharing=True, **kw)
    off = _engine(name).serve_stream(reqs, prefix_sharing=False, **kw)
    _assert_stream_equal(on, off)
    sched = eng_on._stream[1]
    stats = sched.prefix_stats
    assert stats["full_hits"] > 0 and stats["hits"] == stats["full_hits"]
    assert eng_on.stats["prefill_tokens_saved"] == stats["tokens_saved"] > 0
    if name == "zamba2-2.7b":
        assert stats["cow_copies"] > 0
    assert sched.srt.pool.held_slots == sched.lrt.pool.held_slots == []


@pytest.mark.parametrize("name", ARCH_NAMES)
@pytest.mark.parametrize("sharing", [False, True])
def test_chunked_prefill_admission_token_identical(name, sharing):
    """tests/test_chunk_lane.py:139 — chunk_prefill on == off, token for
    token (confidences within ``CONF_TOL``: the chunk lane's per-token
    steps against the admit lane's chunked SSD)."""
    reqs = _requests(name, [8, 24, 16, 24], seed=3)
    kw = dict(buckets=(8, 16, 24), num_slots=3, page_size=8,
              prefix_sharing=sharing, validate=True)
    base = _engine(name).serve_stream(reqs, **kw)
    eng = _engine(name)
    chunked = eng.serve_stream(reqs, **kw, chunk_prefill=True, chunk_size=8)
    _assert_stream_equal(chunked, base, conf_tol=CONF_TOL)
    assert eng._stream[1].srt.lane_ticks["chunk"] > 0


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_stream_single_sync_per_tick(monkeypatch, name):
    """tests/test_scheduler.py:64 — one device->host copy per tick, every
    lane on; on the CPU no kernel wrapper launches."""
    calls = []
    real = engine_mod._host_fetch
    monkeypatch.setattr(engine_mod, "_host_fetch",
                        lambda tree: (calls.append(1), real(tree))[1])
    reqs = _repeated_prompts(name) + _requests(name, [24, 20], seed=5)
    for i, r in enumerate(reqs):
        r.request_id = i
    eng = _engine(name)
    ops.reset_launch_counts()
    eng.serve_stream(reqs, buckets=(12, 16, 24), num_slots=2, page_size=8,
                     chunk_prefill=True, chunk_size=12, validate=True)
    assert len(calls) == eng.stats["stream_ticks"] > 0
    assert set(ops.launch_counts().values()) == {0}
    s = eng._stream[1].srt.lane_ticks
    assert s["admit"] > 0 and s["chunk"] > 0 and s["live"] > 0
