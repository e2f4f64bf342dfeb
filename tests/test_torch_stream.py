"""The port's continuous serving (``HIEngine.serve_stream``) on the CPU.

* Against the reference's ``serve_stream`` (``use_kernel=False``) on bridged
  params, on the ``mixed_poisson`` and ``repeated_prefix`` traces of
  ``benchmarks/bench_serving.py`` at reduced size: every request's status,
  its greedy tokens teacher-forced, and its offload decision.
* The reference's own invariants re-stated on the port: stream == drain,
  one ``_host_fetch`` per tick, per-request ``max_new_tokens`` / eos, fewer
  slots than traffic, sharing on == off and warm replay, backpressure, the
  latency-budget drop, chunk on == off, ``check_invariants`` after every
  tick and no held slots after drain.

Teacher forcing.  The reference holds stream == drain, so each request's
tokens are what its bucketized prompt gives greedily on the contiguous-cache
path.  Both packages' contiguous paths are run along the reference's tokens
(the reference's plain path, the numerics of its ``use_kernel=False``
stream); a token counts where the reference's top1 - top2 logit margin
exceeds twice ``LOGIT_TOL``, so that two sets of logits each within
``LOGIT_TOL`` of the reference's cannot rank it differently (random-init
logits sit near ties).  The port's tokens must equal the reference's up to
the first position that is not decisive.  A confidence and an offload
decision are compared where the request's whole S-tier trajectory is
decisive, the decision only where the reference's confidence is more than
``CONF_TOL`` from theta; queue waits where every decision of the run is.

Tolerances: ``LOGIT_TOL`` = 3e-2.  The port's attention keeps q in float32,
as the reference's Pallas kernels do, where the reference's plain path
rounds q to bf16 (a relative change of up to 2^-9 per element); at this
size that moves logits by up to 1.7e-2 (measured on both traces).
``CONF_TOL`` = 5e-4 on mean max-prob confidences, which the same rounding
moves by up to 1e-4.  The paged API itself is held against the reference's
kernels at 5e-3 in ``test_torch_paged.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from benchmarks.bench_serving import (_poisson_mixed_requests,
                                      _repeated_prefix_requests)
from repro.configs.base import HIConfig as JHIConfig
from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.models import model_zoo as jzoo
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
from repro_torch.serving.faults import STATUSES, FaultSchedule
from repro_torch.serving.kv_pool import KVPool

import torch

LOGIT_TOL = 3e-2
CONF_TOL = 5e-4
STEPS = 3
RECORD_KEYS = {"tokens", "s_tokens", "confidence", "offloaded",
               "served_remote", "dropped", "status", "escalation_retries",
               "queue_wait_ticks", "esc_created_tick", "ttft"}


# ---------------------------------------------------------------------------
# against the reference's serve_stream
# ---------------------------------------------------------------------------

TRACES = {
    # (trace, serve_stream kwargs, max_new_tokens)
    "mixed_poisson": (
        lambda cfg: _poisson_mixed_requests(cfg, 10, 4, seed=0),
        dict(buckets=(16, 32, 64), num_slots=4, l_slots=2, page_size=16,
             decode_block=2, chunk_prefill=True, chunk_size=16), 4),
    "repeated_prefix": (
        # 224-token system prefix: prompts of 232..254 tokens.  The 248
        # bucket's partial tail page (248 = 15.5 pages of 16) makes every
        # full restore of a prompt in it copy-on-write; with the bench's
        # page-aligned (256,) ladder no restore would copy a page
        lambda cfg: _repeated_prefix_requests(cfg, 8, seed=0),
        dict(buckets=(248, 256), num_slots=3, l_slots=2, page_size=16,
             decode_block=3), 4),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op torch thread: the reduced models' small ops run about
    as fast on it, and the suite's other workers keep their cores (the
    thread count is restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _to_port(reqs):
    return [Request(r.request_id, r.prompt, max_new_tokens=r.max_new_tokens)
            for r in reqs]


_JIT = {}


def _jax_fns(cfg):
    """Jitted reference prefill / decode for one config, built once."""
    if cfg not in _JIT:
        _JIT[cfg] = (jax.jit(lambda p, t, c: jzoo.prefill(p, cfg, t, c)),
                     jax.jit(lambda p, t, c: jzoo.decode_step(p, cfg, t, c)))
    return _JIT[cfg]


def _teacher_forced(jcfg, jparams, tcfg, tparams, prompt, toks, cache_len):
    """Both packages' contiguous-path logits along ``toks`` after a (1, S)
    prompt: (n, V) each, row i decides toks[i]."""
    n = len(toks)
    prefill, decode = _jax_fns(jcfg)
    jl, jc = prefill(jparams, jnp.asarray(prompt[None]),
                     jzoo.init_cache(jcfg, 1, cache_len))
    tl, tc = tzoo.prefill(tparams, tcfg,
                          torch.as_tensor(prompt[None], dtype=torch.int64),
                          tzoo.init_cache(tcfg, 1, cache_len, device="cpu"))
    js, ts = [np.asarray(jl[0])], [tl[0].numpy()]
    for i in range(n - 1):
        tok = np.array([[toks[i]]], np.int32)
        jl, jc = decode(jparams, jnp.asarray(tok), jc)
        tl, tc = tzoo.decode_step(tparams, tcfg,
                                  torch.as_tensor(tok, dtype=torch.int64), tc)
        js.append(np.asarray(jl[0]))
        ts.append(tl[0].numpy())
    return np.stack(js), np.stack(ts)


def _check_tokens(jtier, ttier, prompt, ref_toks, got_toks, cache_len):
    """Teacher-forced logits within tolerance; the port's tokens equal the
    reference's up to its first non-decisive position.  Returns how many
    tokens were compared."""
    js, ts = _teacher_forced(jtier.cfg, jtier.params, ttier.cfg,
                             ttier.params, prompt, ref_toks, cache_len)
    np.testing.assert_array_equal(js.argmax(-1), ref_toks)
    np.testing.assert_allclose(ts, js, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    dec = decisive(js, 2 * LOGIT_TOL)
    first = int(np.argmin(dec)) if not dec.all() else len(dec)
    np.testing.assert_array_equal(got_toks[:first], ref_toks[:first])
    return first


@pytest.fixture(scope="module", params=sorted(TRACES))
def trace_engines(request):
    name = request.param
    make, kw, max_new = TRACES[name]
    jcfg = JAX_ARCHS["qwen2-1.5b"].reduced()
    tcfg = ARCHS["qwen2-1.5b"].reduced()
    hi = dict(theta=0.6, capacity_factor=1.0)
    jeng = jax_build_engine(jcfg, JHIConfig(**hi), max_new_tokens=max_new,
                            cache_len=64)
    tiers = [TierModel(c, params_from_numpy(jax.tree.map(np.asarray,
                                                         t.params),
                                            device="cpu"))
             for c, t in ((tcfg.s_variant(4), jeng.s), (tcfg, jeng.l))]
    teng = HIEngine(*tiers, HIConfig(**hi), max_new_tokens=max_new)
    return name, make(jcfg), kw, jeng, teng


def _prefix_stats(eng):
    """An engine's cumulative prefix-cache counters over both tiers."""
    return eng._stream[1].prefix_stats if eng._stream else {}


def test_serve_stream_matches_reference(trace_engines):
    """At theta 0.6 (every request escalates) and then at the reference's
    median S confidence (about half do), on the same engines: the second
    call finds both packages' prefix caches warm.  A third engine on the
    port's tiers indexes prompt pages as the reference does (its chunk lane
    none) and is held to the reference's tick fields and prefix counters
    exactly; the port as it runs saves the same or more, the extra only
    from the chunk lane's pages, and where it does admits and escalates
    each request no later."""
    name, jreqs, kw, jeng, teng = trace_engines
    buckets = kw["buckets"]
    cache_len = max(buckets) + teng.max_new_tokens
    compared = same = 0
    th = 0.6
    # the same tiers with the reference's page indexing: its chunk lane
    # indexes none of the prompt pages it writes
    reng = HIEngine(teng.s, teng.l, teng.hi,
                    max_new_tokens=teng.max_new_tokens)
    for _ in range(2):
        jeng.hi = dataclasses.replace(jeng.hi, theta=th)
        teng.hi = dataclasses.replace(teng.hi, theta=th)
        reng.hi = teng.hi
        engs = (jeng, teng, reng)
        stats0 = [dict(_prefix_stats(e)) for e in engs]
        jout = jeng.serve_stream(jreqs, **kw)
        tout = teng.serve_stream(_to_port(jreqs), validate=True, **kw)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(KVPool, "register_written", lambda *a, **k: None)
            rout = reng.serve_stream(_to_port(jreqs), validate=True, **kw)
        j_st, t_st, r_st = ({k: _prefix_stats(e)[k] - s0.get(k, 0)
                             for k in _prefix_stats(e)}
                            for e, s0 in zip(engs, stats0))
        assert set(tout) == set(jout) == {r.request_id for r in jreqs}
        sched = teng._stream[1]
        assert sched.srt.pool.held_slots == sched.lrt.pool.held_slots == []
        all_decided = True
        for r in jreqs:
            rid = r.request_id
            j, t = jout[rid], tout[rid]
            assert set(t) == RECORD_KEYS
            assert t["status"] == j["status"]
            prompt = np.zeros(pad_to_bucket(len(r.prompt), buckets), np.int32)
            prompt[: len(r.prompt)] = r.prompt
            compared += _check_tokens(jeng.s, teng.s, prompt, j["s_tokens"],
                                      t["s_tokens"], cache_len)
            # the same trajectory: the confidences differ by numerics only
            if not np.array_equal(t["s_tokens"], j["s_tokens"]) \
                    or abs(j["confidence"] - th) <= CONF_TOL:
                all_decided = False
                continue
            same += 1
            assert abs(t["confidence"] - j["confidence"]) <= CONF_TOL
            assert t["offloaded"] == j["offloaded"]
            assert t["served_remote"] == j["served_remote"]
            if j["served_remote"]:
                compared += _check_tokens(jeng.l, teng.l, prompt,
                                          j["tokens"], t["tokens"], cache_len)
            else:
                np.testing.assert_array_equal(t["tokens"], t["s_tokens"])
        # with the reference's indexing the port saves what it saves; as
        # it runs, it differs only through the pages its chunk lane indexed
        # (which also compete with full entries for the pool), and saves
        # no fewer prompt tokens
        assert r_st["chunk_registered"] == 0
        for key in ("hits", "full_hits", "tokens_saved"):
            assert r_st[key] == j_st[key], key
            if t_st["chunk_registered"] == 0:
                assert t_st[key] == j_st[key], key
        assert t_st["tokens_saved"] >= j_st["tokens_saved"]
        extra = t_st["tokens_saved"] > j_st["tokens_saved"]
        if all_decided:
            for rid in jout:
                j, t = jout[rid], tout[rid]
                for key in ("queue_wait_ticks", "esc_created_tick",
                            "escalation_retries", "dropped"):
                    assert rout[rid][key] == j[key], (rid, key)
                    if not extra or key in ("escalation_retries", "dropped"):
                        assert t[key] == j[key], (rid, key)
                if extra:
                    # the chunk lane's pages end the S prompt sooner: each
                    # request escalates, and its L tier admits it, no later
                    assert t["esc_created_tick"] <= j["esc_created_tick"], rid
                    assert (t["esc_created_tick"] + t["queue_wait_ticks"]
                            <= j["esc_created_tick"] + j["queue_wait_ticks"]
                            ), rid
        th = float(np.median([rec["confidence"] for rec in jout.values()]))
    assert compared > 0 and same > 0
    if name == "repeated_prefix":
        stats = teng._stream[1].prefix_stats
        assert stats["full_hits"] > 0 and stats["cow_copies"] > 0
        assert teng.stats["prefill_tokens_saved"] == stats["tokens_saved"]
    assert teng.stats["stream_compiles"] == 1


# ---------------------------------------------------------------------------
# the reference's invariants, re-stated on the port
# ---------------------------------------------------------------------------

def _cfg():
    return ARCHS["qwen2-1.5b"].reduced()


def _engine(theta=0.6, max_new=STEPS, cache_len=32, seed=0):
    return build_engine(_cfg(), HIConfig(theta=theta, capacity_factor=1.0),
                        seed=seed, max_new_tokens=max_new,
                        cache_len=cache_len, device="cpu")


def _mixed_requests(lens, rng, steps=STEPS):
    cfg = _cfg()
    return [Request(i, rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                    max_new_tokens=steps) for i, n in enumerate(lens)]


def _drain_by_bucket(eng, reqs):
    out = {}
    for n in sorted({len(r.prompt) for r in reqs}):
        sub = [r for r in reqs if len(r.prompt) == n]
        res = eng.serve(np.stack([r.prompt for r in sub]))
        for j, r in enumerate(sub):
            out[r.request_id] = {k: res[k][j] for k in res}
    return out


def _assert_stream_equal(a, b, conf_tol=1e-6):
    assert set(a) == set(b)
    for rid in b:
        np.testing.assert_array_equal(a[rid]["tokens"], b[rid]["tokens"])
        np.testing.assert_array_equal(a[rid]["s_tokens"], b[rid]["s_tokens"])
        assert a[rid]["offloaded"] == b[rid]["offloaded"]
        assert a[rid]["served_remote"] == b[rid]["served_remote"]
        assert a[rid]["status"] == b[rid]["status"]
        assert abs(a[rid]["confidence"] - b[rid]["confidence"]) <= conf_tol


def test_stream_matches_drain_on_mixed_lengths():
    """tests/test_scheduler.py:36 — token-identical greedy outputs to the
    drain path on mixed-length traffic, one scheduler across buckets."""
    reqs = _mixed_requests([8, 16, 8, 16, 8], np.random.default_rng(7))
    drain = _drain_by_bucket(_engine(), reqs)
    eng = _engine()
    stream = eng.serve_stream(reqs, buckets=(8, 16), num_slots=3,
                              page_size=8)
    assert set(stream) == {r.request_id for r in reqs}
    for rid, rec in stream.items():
        np.testing.assert_array_equal(rec["tokens"], drain[rid]["tokens"])
        np.testing.assert_array_equal(rec["s_tokens"], drain[rid]["s_tokens"])
        assert rec["offloaded"] == bool(drain[rid]["offloaded"])
        np.testing.assert_allclose(rec["confidence"],
                                   drain[rid]["confidence"], atol=1e-5)
    assert eng.stats["stream_compiles"] == 1


@pytest.mark.parametrize("sharing,chunk", [(False, False), (True, True)])
def test_stream_single_sync_per_tick(monkeypatch, sharing, chunk):
    """tests/test_scheduler.py:64 — exactly one device->host copy per tick,
    through ``_host_fetch``, with every lane on or off."""
    calls = []
    real = engine_mod._host_fetch
    monkeypatch.setattr(engine_mod, "_host_fetch",
                        lambda tree: (calls.append(1), real(tree))[1])
    eng = _engine()
    reqs = _mixed_requests([8, 16, 8, 16], np.random.default_rng(0))
    eng.serve_stream(reqs + [Request(9, reqs[1].prompt, max_new_tokens=2)],
                     buckets=(8, 16), num_slots=2, page_size=8,
                     prefix_sharing=sharing, chunk_prefill=chunk)
    assert len(calls) == eng.stats["stream_ticks"] > 0


def test_stream_lane_counts_follow_the_host_flags():
    """On the CPU the kernel wrappers never launch; the lanes that ran are
    counted per tier from the host's own flags."""
    eng = _engine()
    ops.reset_launch_counts()
    reqs = _mixed_requests([8, 16, 8], np.random.default_rng(1))
    eng.serve_stream(reqs, buckets=(8, 16), num_slots=2, page_size=8,
                     chunk_prefill=True, chunk_size=8)
    sched = eng._stream[1]
    assert set(ops.launch_counts().values()) == {0}
    s = sched.srt.lane_ticks
    assert s["live"] > 0 and s["chunk"] > 0 and s["admit"] > 0
    assert s["live"] <= eng.stats["stream_ticks"]


def test_stream_per_request_max_new_and_eos():
    """tests/test_scheduler.py:104."""
    rng = np.random.default_rng(9)
    cfg = _cfg()
    r_short = Request(0, rng.integers(0, cfg.vocab_size, 8).astype(np.int32),
                      max_new_tokens=2)
    r_long = Request(1, rng.integers(0, cfg.vocab_size, 8).astype(np.int32),
                     max_new_tokens=6)
    out = _engine(theta=0.0, max_new=6).serve_stream(
        [r_short, r_long], buckets=(8,), num_slots=2, page_size=8)
    assert len(out[0]["tokens"]) == 2
    assert len(out[1]["tokens"]) == 6
    first = int(out[1]["tokens"][0])
    r_eos = Request(1, r_long.prompt, max_new_tokens=6, eos_id=first)
    out2 = _engine(theta=0.0, max_new=6).serve_stream(
        [r_eos], buckets=(8,), num_slots=2, page_size=8)
    assert len(out2[1]["tokens"]) == 1
    assert int(out2[1]["tokens"][0]) == first


def test_stream_slot_count_smaller_than_traffic():
    """tests/test_scheduler.py:129 — slots are recycled and everyone is
    served once; every record has one status."""
    eng = _engine(theta=1.1)
    reqs = _mixed_requests([8] * 5, np.random.default_rng(4))
    out = eng.serve_stream(reqs, buckets=(8,), num_slots=2, page_size=8,
                           validate=True)
    assert len(out) == 5
    assert all(rec["offloaded"] and rec["served_remote"]
               for rec in out.values())
    assert all(rec["status"] in STATUSES and set(rec) == RECORD_KEYS
               for rec in out.values())
    assert eng.stats["offloaded"] == 5
    sched = eng._stream[1]
    assert sched.srt.pool.held_slots == sched.lrt.pool.held_slots == []


def _repeated_prefix_traffic(seed=3):
    """tests/test_prefix_cache.py:21 — a shared 8-token prefix and repeats:
    the 12 bucket's partial tail page makes restores copy-on-write."""
    cfg = _cfg()
    rng = np.random.default_rng(seed)
    base = rng.integers(0, cfg.vocab_size, 8).astype(np.int32)

    def mk(n):
        return np.concatenate(
            [base, rng.integers(0, cfg.vocab_size, n).astype(np.int32)])

    p1, p2, p3 = mk(4), mk(8), mk(8)
    order = [p1, p2, p3, p1, p2, p3, p1, p2]
    return [Request(i, p, max_new_tokens=STEPS) for i, p in enumerate(order)]


def test_sharing_equivalence():
    """tests/test_prefix_cache.py:51 — sharing on == off, token for token,
    while the cache hits (full restores, partial hits and COW)."""
    reqs = _repeated_prefix_traffic()
    kw = dict(buckets=(12, 16), num_slots=2, page_size=8, validate=True)
    eng_on = _engine()
    on = eng_on.serve_stream(reqs, prefix_sharing=True, **kw)
    off = _engine().serve_stream(reqs, prefix_sharing=False, **kw)
    _assert_stream_equal(on, off)
    sched = eng_on._stream[1]
    stats = sched.prefix_stats
    assert stats["full_hits"] > 0 and stats["tokens_saved"] > 0
    assert stats["hits"] > stats["full_hits"] and stats["cow_copies"] > 0
    assert eng_on.stats["prefill_tokens_saved"] == stats["tokens_saved"]
    sched.srt.pool.check_invariants()
    sched.lrt.pool.check_invariants()
    assert eng_on.stats["stream_compiles"] == 1


def test_warm_cache_replay_stays_equivalent():
    """tests/test_prefix_cache.py:82 — a second call reuses the scheduler
    and its prefix index: every repeat full-restores on both tiers."""
    reqs = _repeated_prefix_traffic()
    kw = dict(buckets=(12, 16), num_slots=2, page_size=8)
    eng_on, eng_off = _engine(theta=1.1), _engine(theta=1.1)
    eng_on.serve_stream(reqs, prefix_sharing=True, **kw)
    sched = eng_on._stream[1]
    hits0 = sched.prefix_stats["full_hits"]
    l_saved0 = sched.lrt.pool.stats["tokens_saved"]
    on = eng_on.serve_stream(reqs, prefix_sharing=True, **kw)
    off = eng_off.serve_stream(reqs, prefix_sharing=False, **kw)
    _assert_stream_equal(on, off)
    assert sched.prefix_stats["full_hits"] >= hits0 + len(reqs)
    assert sched.lrt.pool.stats["tokens_saved"] > l_saved0
    assert eng_on.stats["stream_compiles"] == 1
    sched.srt.pool.check_invariants()
    sched.lrt.pool.check_invariants()


def test_same_tick_row_recycling_keeps_restore_intact():
    """tests/test_prefix_cache.py:170 — with one prefix row, a tick that
    restores from the row and recycles it for a new save must restore the
    pre-save logits."""
    cfg = _cfg()
    rng = np.random.default_rng(11)
    p1 = rng.integers(0, cfg.vocab_size, 16).astype(np.int32)
    p2 = rng.integers(0, cfg.vocab_size, 16).astype(np.int32)
    kw = dict(buckets=(16,), num_slots=2, page_size=8, prefix_entries=1)
    outs = {}
    for sharing in (True, False):
        eng = _engine(theta=0.0)
        eng.serve_stream([Request(0, p1, max_new_tokens=STEPS)],
                         prefix_sharing=sharing, **kw)
        outs[sharing] = eng.serve_stream(
            [Request(1, p1, max_new_tokens=STEPS),
             Request(2, p2, max_new_tokens=STEPS)],
            prefix_sharing=sharing, **kw)
    _assert_stream_equal(outs[True], outs[False])


def test_pool_exhaustion_backpressure_retries():
    """tests/test_prefix_cache.py:108 — admission retries instead of
    crashing, serves everyone once and leaks no pages."""
    from repro_torch.serving.batcher import AdmissionQueue
    from repro_torch.serving.scheduler import ContinuousScheduler

    eng = _engine(theta=0.0)
    hi = eng.hi
    sched = ContinuousScheduler(
        eng.s, eng.l, hi, max_prompt_len=16, max_new_tokens=STEPS,
        num_slots=3, l_slots=2, page_size=8, decode_block=2,
        prefix_sharing=True, num_pages=6)
    queue = AdmissionQueue(buckets=(16,), page_size=8)
    rng = np.random.default_rng(5)
    for i in range(6):
        queue.submit(Request(i, rng.integers(0, _cfg().vocab_size, 16)
                             .astype(np.int32), max_new_tokens=STEPS))
    sched.set_faults(validate=True)
    results = sched.run(queue)
    assert set(results) == set(range(6))
    assert all(len(r["tokens"]) == STEPS for r in results.values())
    sched.srt.pool.check_invariants()
    sched.lrt.pool.check_invariants()
    assert sched.srt.busy == 0 and sched.lrt.busy == 0


def test_unsatisfiable_admission_is_rejected():
    """A prompt larger than the whole pool: after the retry limit the
    request ends ``rejected`` with no tokens; the others are served."""
    from repro_torch.serving.batcher import AdmissionQueue
    from repro_torch.serving.faults import RetryPolicy
    from repro_torch.serving.scheduler import ContinuousScheduler

    eng = _engine(theta=0.0)
    sched = ContinuousScheduler(
        eng.s, eng.l, eng.hi, max_prompt_len=32, max_new_tokens=STEPS,
        num_slots=2, page_size=8, prefix_sharing=False, num_pages=4)
    queue = AdmissionQueue(buckets=(8, 32))
    rng = np.random.default_rng(6)
    queue.submit(Request(0, rng.integers(0, 100, 32).astype(np.int32),
                         max_new_tokens=STEPS))
    queue.submit(Request(1, rng.integers(0, 100, 8).astype(np.int32),
                         max_new_tokens=STEPS))
    sched.set_faults(policy=RetryPolicy(admit_retry_limit=2))
    with pytest.warns(RuntimeWarning, match="rejected"):
        results = sched.run(queue)
    assert results[0]["status"] == "rejected" and len(results[0]["tokens"]) == 0
    assert results[1]["status"] == "ok" and len(results[1]["tokens"]) == STEPS
    assert sched.stats["rejected"] == 1


def test_latency_budget_drop_policy():
    """tests/test_prefix_cache.py:139 — an escalation past its budget is
    dropped from the L queue; the S answer stands."""
    cfg = _cfg()
    rng = np.random.default_rng(9)
    expired = Request(0, rng.integers(0, cfg.vocab_size, 8).astype(np.int32),
                      max_new_tokens=STEPS, latency_budget=0.0)
    patient = Request(1, rng.integers(0, cfg.vocab_size, 8).astype(np.int32),
                      max_new_tokens=STEPS, latency_budget=None)
    eng = _engine(theta=1.1)
    out = eng.serve_stream([expired, patient], buckets=(8,), num_slots=2,
                           page_size=8)
    assert out[0]["dropped"] and not out[0]["served_remote"]
    assert out[0]["status"] == "dropped" and out[0]["offloaded"]
    np.testing.assert_array_equal(out[0]["tokens"], out[0]["s_tokens"])
    assert not out[1]["dropped"] and out[1]["served_remote"]
    assert out[1]["status"] == "ok"
    assert eng.stats["dropped"] == 1
    ref = _engine(theta=1.1).serve_stream(
        [Request(0, expired.prompt, max_new_tokens=STEPS)], buckets=(8,),
        num_slots=2, page_size=8)
    np.testing.assert_array_equal(out[0]["tokens"], ref[0]["s_tokens"])


@pytest.mark.parametrize("sharing", [False, True])
def test_chunked_prefill_admission_token_identical(sharing):
    """tests/test_chunk_lane.py:139 — chunk_prefill on == off, token for
    token (confidences within 1e-4: the chunk lane attends with q in
    float32 like the kernels, the admit lane's prefill rounds q to bf16)."""
    cfg = _cfg()
    rng = np.random.default_rng(3)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                    max_new_tokens=4) for i, n in enumerate([8, 24, 16, 24])]
    kw = dict(buckets=(8, 16, 24), num_slots=3, page_size=8,
              prefix_sharing=sharing, validate=True)
    base = _engine(max_new=4, cache_len=48).serve_stream(reqs, **kw)
    eng = _engine(max_new=4, cache_len=48)
    chunked = eng.serve_stream(reqs, **kw, chunk_prefill=True, chunk_size=8)
    _assert_stream_equal(chunked, base, conf_tol=CONF_TOL)
    assert all(chunked[r]["ttft"] >= 0.0 for r in chunked)
    assert eng._stream[1].srt.lane_ticks["chunk"] > 0
    assert eng.stats["stream_compiles"] == 1


def test_no_stale_reads_after_slot_reuse():
    """tests/test_kv_pool.py:212 — a slot reused after a longer request
    gives bit-identical output to a fresh engine."""
    cfg = _cfg()
    rng = np.random.default_rng(11)
    long_req = Request(0, rng.integers(0, cfg.vocab_size, 32).astype(np.int32),
                       max_new_tokens=3)
    short_req = Request(1, rng.integers(0, cfg.vocab_size, 8).astype(np.int32),
                        max_new_tokens=3)
    eng = _engine(theta=0.0, cache_len=64)
    eng.serve_stream([long_req], buckets=(8, 32), num_slots=1, page_size=8)
    reused = eng.serve_stream([short_req], buckets=(8, 32), num_slots=1,
                              page_size=8)
    fresh = _engine(theta=0.0, cache_len=64).serve_stream(
        [short_req], buckets=(8, 32), num_slots=1, page_size=8)
    np.testing.assert_array_equal(reused[1]["tokens"], fresh[1]["tokens"])
    assert reused[1]["confidence"] == fresh[1]["confidence"]


class _DataOnlyMesh:
    """A mesh stand-in whose axes lack ``model``."""
    shape = {"data": 1}


@pytest.mark.parametrize("kwargs,exc,match", [
    # the refusals that still stand, each with the reference's message:
    # speculative mode has no L queue for a fault schedule to act on ...
    (dict(speculative=True, faults=FaultSchedule(loss_prob=0.5)),
     ValueError, "speculative mode has no L queue"),
    # ... also when installed on the scheduler itself
    (dict(speculative=True, set_faults=FaultSchedule(loss_prob=0.5)),
     ValueError, "speculative mode has no L queue"),
    # a mesh without both serving axes: the reference's message
    (dict(mesh=_DataOnlyMesh()), ValueError, "serving mesh needs axes"),
    # speculative acceptance is greedy-only
    (dict(speculative=True, temperature=0.7), NotImplementedError,
     "greedy-only"),
    (dict(speculative=True, mesh=object()), NotImplementedError,
     r"speculative \+ mesh"),
])
def test_unported_options_raise(kwargs, exc, match):
    kwargs = dict(kwargs)
    reqs = _mixed_requests([8], np.random.default_rng(0))
    temp = kwargs.pop("temperature", 0.0)
    if temp:
        reqs = [Request(r.request_id, r.prompt, max_new_tokens=STEPS,
                        temperature=temp) for r in reqs]
    eng = _engine()
    faults = kwargs.pop("set_faults", None)
    if faults is not None:
        from repro_torch.serving.scheduler import ContinuousScheduler
        sched = ContinuousScheduler(eng.s, eng.l, eng.hi, max_prompt_len=8,
                                    max_new_tokens=STEPS, num_slots=2,
                                    page_size=8, **kwargs)
        with pytest.raises(exc, match=match):
            sched.set_faults(faults)
        return
    with pytest.raises(exc, match=match):
        eng.serve_stream(reqs, buckets=(8,), num_slots=2, page_size=8,
                         **kwargs)


def test_sampled_stream_is_reproducible():
    """A request at temperature > 0 samples under its own keys: two runs
    give the same tokens, and they part from greedy."""
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, _cfg().vocab_size, 8).astype(np.int32)
               for _ in range(3)]
    reqs = [Request(i, p, max_new_tokens=STEPS, temperature=2.0)
            for i, p in enumerate(prompts)]
    kw = dict(buckets=(8,), num_slots=2, page_size=8)
    a = _engine(theta=0.0).serve_stream(reqs, **kw)
    b = _engine(theta=0.0).serve_stream(reqs, **kw)
    greedy = _engine(theta=0.0).serve_stream(
        [Request(i, p, max_new_tokens=STEPS) for i, p in enumerate(prompts)],
        **kw)
    for rid in a:
        np.testing.assert_array_equal(a[rid]["tokens"], b[rid]["tokens"])
    assert any(not np.array_equal(a[r]["tokens"], greedy[r]["tokens"])
               for r in a)
