"""Fault schedules, retries and the circuit breaker on the port's
``serve_stream``, held against the reference's on the same schedule.

Re-states ``tests/test_faults.py`` and ``tests/test_chaos.py``.  Both
packages serve the same traffic (the reference's ``KW`` and ``_reqs``) on
bridged params under the same ``FaultSchedule`` / ``RetryPolicy``, each
built from its own package:

* the records' host fields are exactly equal: ``status``,
  ``escalation_retries``, ``queue_wait_ticks``, ``esc_created_tick``,
  ``served_remote``, ``dropped`` and ``offloaded`` (at theta 1.1 every
  request escalates, so these depend on ticks alone, never on numerics);
* tokens under the margin rule of ``tests/test_torch_stream.py``
  (teacher-forced logits within ``LOGIT_TOL``, tokens equal up to the first
  position that is not decisive);
* the reference's own cases on the port: the breaker state machine,
  determinism, lost escalations degrading to local, an outage opening and
  closing the breaker, pure delay, ``drop_expired`` releasing every L
  resource, bounded admission rejection and the spike; then the chaos
  property, a seeded sweep always and a hypothesis search where hypothesis
  is installed.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import HIConfig as JHIConfig
from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.serving import faults as jfaults
from repro.serving.batcher import Request as JRequest
from repro.serving.engine import build_engine as jax_build_engine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import HIConfig
from repro_torch.configs.registry import ARCHS
from repro_torch.serving import faults as tfaults
from repro_torch.serving.batcher import Request
from repro_torch.serving.engine import HIEngine, TierModel, build_engine
from repro_torch.serving.faults import (STATUSES, CircuitBreaker,
                                        FaultSchedule, RetryPolicy)
from test_torch_stream import _check_tokens

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:                                   # pragma: no cover
    HAVE_HYPOTHESIS = False

STEPS = 3
KW = dict(buckets=(8,), num_slots=2, page_size=8)
HOST_FIELDS = ("status", "escalation_retries", "queue_wait_ticks",
               "esc_created_tick", "served_remote", "dropped", "offloaded")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op torch thread: the reduced models' small ops run about
    as fast on it, and the suite's other workers keep their cores (the
    thread count is restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reqs(n, cls=Request, **kw):
    """tests/test_faults.py's traffic: n prompts of 8 tokens."""
    cfg = ARCHS["qwen2-1.5b"].reduced()
    rng = np.random.default_rng(0)
    return [cls(i, rng.integers(0, cfg.vocab_size, 8).astype(np.int32),
                max_new_tokens=STEPS, **kw) for i in range(n)]


def _pair(theta, cache_len=32):
    """The reference's engine and the port's on its params (bridged)."""
    jcfg = JAX_ARCHS["qwen2-1.5b"].reduced()
    tcfg = ARCHS["qwen2-1.5b"].reduced()
    hi = dict(theta=theta, capacity_factor=1.0)
    jeng = jax_build_engine(jcfg, JHIConfig(**hi), max_new_tokens=STEPS,
                            cache_len=cache_len)
    thi = HIConfig(**hi)
    tiers = [TierModel(c, params_from_numpy(jax.tree.map(np.asarray,
                                                         t.params),
                                            device="cpu"))
             for c, t in ((tcfg.s_variant(thi.s_scale), jeng.s),
                          (tcfg, jeng.l))]
    return jeng, HIEngine(*tiers, thi, max_new_tokens=STEPS)


@pytest.fixture(scope="module")
def pair():
    """One engine pair shared by every scenario: fault schedules are
    per-run state, so reuse across schedules is itself part of the test.
    theta 1.1 > any confidence: every request escalates."""
    return _pair(1.1)


def _both(pair, faults=None, retry=None, n=6, **req_kw):
    """The same schedule through both packages; each builds its own."""
    jeng, teng = pair
    kw = {}
    if faults is not None:
        kw["faults"] = (jfaults.FaultSchedule(**faults),
                        tfaults.FaultSchedule(**faults))
    if retry is not None:
        kw["retry"] = (jfaults.RetryPolicy(**retry),
                       tfaults.RetryPolicy(**retry))
    jout = jeng.serve_stream(_reqs(n, JRequest, **req_kw), validate=True,
                             **{k: v[0] for k, v in kw.items()}, **KW)
    tout = teng.serve_stream(_reqs(n, **req_kw), validate=True,
                             **{k: v[1] for k, v in kw.items()}, **KW)
    _compare(jeng, teng, jout, tout, n)
    return jout, tout


def _compare(jeng, teng, jout, tout, n):
    assert set(tout) == set(jout) == set(range(n))
    prompts = {r.request_id: r.prompt for r in _reqs(n)}
    for rid, j in jout.items():
        t = tout[rid]
        for key in HOST_FIELDS:
            assert t[key] == j[key], (rid, key, t[key], j[key])
        _check_tokens(jeng.s, teng.s, prompts[rid], j["s_tokens"],
                      t["s_tokens"], 32)
        if j["served_remote"]:
            _check_tokens(jeng.l, teng.l, prompts[rid], j["tokens"],
                          t["tokens"], 32)
        else:
            np.testing.assert_array_equal(t["tokens"], t["s_tokens"])
    sched = teng._stream[1]
    assert sched.srt.pool.held_slots == sched.lrt.pool.held_slots == []


# ---------------------------------------------------------------------------
# faults.py units, against the reference's
# ---------------------------------------------------------------------------

def test_fault_schedule_deterministic():
    """tests/test_faults.py:49 — every transit decision is a pure function
    of (seed, rid, attempt), in any call order, and the port's draws are
    the reference's."""
    kw = dict(seed=7, loss_prob=0.4, delay_ticks=1, delay_jitter=3)
    fs, jfs = FaultSchedule(**kw), jfaults.FaultSchedule(**kw)
    draws = [(rid, att, fs.transit(rid, att))
             for rid in range(20) for att in range(3)]
    for rid, att, d in reversed(draws):
        assert fs.transit(rid, att) == d == jfs.transit(rid, att)
    assert any(d is None for _, _, d in draws)
    kept = [d for _, _, d in draws if d is not None]
    assert kept and all(1 <= d <= 4 for d in kept)
    fs2 = FaultSchedule(seed=8, loss_prob=0.4, delay_ticks=1, delay_jitter=3)
    assert [fs2.transit(r, a) for r, a, _ in draws] != [d for _, _, d in draws]
    fs3 = FaultSchedule(outages=((2, 5),), spikes=((7, 9),))
    assert not fs3.in_outage(1) and fs3.in_outage(2) and fs3.in_outage(4)
    assert not fs3.in_outage(5)
    assert fs3.l_paused(8) and not fs3.l_paused(6)


def test_circuit_breaker_state_machine():
    """tests/test_faults.py:72 — closed -> open on consecutive failures,
    cooldown -> half-open, a failed probe re-opens, a good one closes; the
    port's breaker walks the reference's states."""
    pol = dict(breaker_threshold=3, breaker_cooldown_ticks=5)
    brks = (CircuitBreaker(RetryPolicy(**pol)),
            jfaults.CircuitBreaker(jfaults.RetryPolicy(**pol)))
    seen = []
    for brk in brks:
        trace = []
        brk.record_failure(0)
        brk.record_success()
        brk.record_failure(1)
        brk.record_failure(1)
        trace.append(brk.state_at(2))
        brk.record_failure(2)
        trace += [brk.state, brk.opens, brk.state_at(6), brk.state_at(7)]
        brk.record_failure(7)
        trace += [brk.state, brk.opens, brk.state_at(12)]
        brk.record_success()
        trace += [brk.state, brk.failures]
        seen.append(trace)
    C = CircuitBreaker
    assert seen[0] == [C.CLOSED, C.OPEN, 1, C.OPEN, C.HALF_OPEN, C.OPEN, 2,
                       C.HALF_OPEN, C.CLOSED, 0]
    assert seen[0] == seen[1]


def test_speculative_mode_rejects_active_faults():
    """tests/test_faults.py:92 — the fused speculative cascade has no L
    queue, so an active schedule is refused; ``NO_FAULTS`` is not."""
    from repro_torch.serving.scheduler import ContinuousScheduler
    eng = build_engine(ARCHS["qwen2-1.5b"].reduced(),
                       HIConfig(theta=0.5, capacity_factor=1.0),
                       max_new_tokens=STEPS, cache_len=32, device="cpu")
    sched = ContinuousScheduler(eng.s, eng.l, eng.hi, max_prompt_len=8,
                                max_new_tokens=STEPS, num_slots=2,
                                page_size=8, speculative=True)
    with pytest.raises(ValueError, match="speculative"):
        sched.set_faults(FaultSchedule(loss_prob=0.5))
    sched.set_faults(tfaults.NO_FAULTS)


# ---------------------------------------------------------------------------
# scheduler resilience end to end, port against reference
# ---------------------------------------------------------------------------

def test_lost_escalations_degrade_local(pair):
    """tests/test_faults.py:107 — total loss: retries exhaust and every
    request degrades to its S answer, leak-free, one scheduler."""
    _, teng = pair
    deg0 = teng.stats["degraded_local"]
    _, out = _both(pair, faults=dict(seed=3, loss_prob=1.0),
                   retry=dict(ack_timeout_ticks=1, max_retries=1,
                              breaker_threshold=100))
    for rec in out.values():
        assert rec["status"] == "degraded_local"
        assert rec["offloaded"] and not rec["served_remote"]
        assert rec["escalation_retries"] == 1
    assert teng.stats["degraded_local"] - deg0 == 6
    assert teng.stats["esc_lost"] >= 6
    assert teng.stats["stream_compiles"] == 1


def test_outage_opens_breaker_then_recovers(pair):
    """tests/test_faults.py:133 — an L outage aborts in-flight L work
    (pages back through ``KVPool.free``), the breaker opens into
    fail-local, and after the window and the cooldown later requests are
    served remote again."""
    _, teng = pair
    opens0 = teng.stats["breaker_opens"]
    open_ticks0 = teng.stats["breaker_open_ticks"]
    _, out = _both(pair, faults=dict(seed=5, outages=((1, 4),)),
                   retry=dict(ack_timeout_ticks=1, max_retries=1,
                              breaker_threshold=2, breaker_cooldown_ticks=2),
                   n=8)
    statuses = {rec["status"] for rec in out.values()}
    assert statuses == {"ok", "degraded_local"}
    assert teng.stats["breaker_opens"] > opens0
    assert teng.stats["breaker_open_ticks"] > open_ticks0
    sched = teng._stream[1]
    sched.srt.pool.check_invariants()
    sched.lrt.pool.check_invariants()


def test_pure_delay_keeps_outputs_identical(pair):
    """tests/test_faults.py:168 — delay alone only stretches the queue
    wait: every escalation lands on L with the fault-free tokens."""
    _, teng = pair
    ref = teng.serve_stream(_reqs(6), validate=True, **KW)
    _, out = _both(pair, faults=dict(seed=11, delay_ticks=2, delay_jitter=2),
                   retry=dict(ack_timeout_ticks=8))
    for rid, rec in out.items():
        assert rec["status"] == "ok" and rec["served_remote"]
        assert rec["queue_wait_ticks"] >= 2
        np.testing.assert_array_equal(rec["tokens"], ref[rid]["tokens"])


def test_drop_expired_releases_every_l_resource(pair):
    """tests/test_faults.py:185 — a queued escalation reserves nothing on
    the L side, so repeated drops leave the L tier holding no slot."""
    _, teng = pair
    for _ in range(2):
        _, out = _both(pair, latency_budget=0.0)
        for rec in out.values():
            assert rec["status"] == "dropped" and rec["dropped"]
            assert rec["offloaded"] and not rec["served_remote"]
        sched = teng._stream[1]
        sched.srt.pool.check_invariants()
        sched.lrt.pool.check_invariants()
        assert sched.lrt.pool.held_slots == []


def test_admission_rejection_is_bounded():
    """tests/test_faults.py:206 — a prompt whose page demand can never be
    met ends ``rejected`` after ``admit_retry_limit`` ticks, and the
    traffic behind it is served; the reference's scheduler gives the same
    records."""
    from repro.serving.scheduler import ContinuousScheduler as JSched
    from repro.serving.batcher import AdmissionQueue as JQueue
    from repro_torch.serving.batcher import AdmissionQueue
    from repro_torch.serving.scheduler import ContinuousScheduler

    jeng, teng = _pair(0.0)
    kw = dict(max_prompt_len=16, max_new_tokens=STEPS, num_slots=2,
              l_slots=1, page_size=8, decode_block=2, prefix_sharing=False,
              num_pages=3)
    rng = np.random.default_rng(2)
    vocab = ARCHS["qwen2-1.5b"].reduced().vocab_size
    prompts = [rng.integers(0, vocab, 16).astype(np.int32),
               rng.integers(0, vocab, 8).astype(np.int32)]
    results = []
    for sched, queue, req, pol in (
            (JSched(jeng.s, jeng.l, jeng.hi, **kw), JQueue(buckets=(8, 16)),
             JRequest, jfaults.RetryPolicy(admit_retry_limit=4)),
            (ContinuousScheduler(teng.s, teng.l, teng.hi, **kw),
             AdmissionQueue(buckets=(8, 16)), Request,
             RetryPolicy(admit_retry_limit=4))):
        sched.set_faults(policy=pol, validate=True)
        for i, p in enumerate(prompts):
            queue.submit(req(i, p, max_new_tokens=STEPS))
        with pytest.warns(RuntimeWarning, match="rejected"):
            results.append(sched.run(queue))
        assert sched.stats["rejected"] == 1
        assert sched.srt.pool.held_slots == sched.lrt.pool.held_slots == []
    jres, tres = results
    assert tres[0]["status"] == "rejected" and len(tres[0]["tokens"]) == 0
    assert tres[1]["status"] == "ok" and len(tres[1]["tokens"]) == STEPS
    for rid in (0, 1):
        for key in HOST_FIELDS:
            assert tres[rid][key] == jres[rid][key], (rid, key)


def test_spike_window_delays_but_serves(pair):
    """tests/test_faults.py:240 — a latency spike pauses L admission
    without failing anything; the wait shows in the records."""
    _, out = _both(pair, faults=dict(seed=13, spikes=((0, 8),)))
    for rec in out.values():
        assert rec["status"] == "ok" and rec["served_remote"]
    assert any(rec["queue_wait_ticks"] >= 3 for rec in out.values())


def test_fault_records_replay_identically(pair):
    """Fault timing is a function of (seed, rid, attempt, run-relative
    tick): the same schedule twice on one scheduler gives equal records,
    field by field."""
    _, teng = pair
    kw = dict(faults=FaultSchedule(seed=5, loss_prob=0.25, delay_ticks=1,
                                   delay_jitter=2, outages=((2, 6),),
                                   spikes=((7, 10),)),
              retry=RetryPolicy(ack_timeout_ticks=2, max_retries=2,
                                backoff_cap_ticks=4, breaker_threshold=2,
                                breaker_cooldown_ticks=4))
    a = teng.serve_stream(_reqs(8), validate=True, **kw, **KW)
    b = teng.serve_stream(_reqs(8), validate=True, **kw, **KW)
    assert set(a) == set(b)
    for rid in a:
        for key, v in a[rid].items():
            if key == "ttft":
                continue
            np.testing.assert_array_equal(b[rid][key], v, err_msg=key)


# ---------------------------------------------------------------------------
# the chaos property (tests/test_chaos.py) on the port
# ---------------------------------------------------------------------------

CHAOS_KW = dict(buckets=(8, 16), num_slots=3, l_slots=2, page_size=8)
_CHAOS = {}


def _chaos_requests():
    """Mixed traffic: two buckets, a zero-budget straggler."""
    rng = np.random.default_rng(42)
    reqs = []
    for i in range(7):
        n = int(rng.integers(4, 16))
        reqs.append(Request(i, rng.integers(0, 500, n).astype(np.int32),
                            max_new_tokens=STEPS,
                            latency_budget=0.0 if i == 5 else None))
    return reqs


def _chaos_state():
    if not _CHAOS:
        eng = build_engine(ARCHS["qwen2-1.5b"].reduced(),
                           HIConfig(theta=0.6, capacity_factor=1.0),
                           max_new_tokens=STEPS, cache_len=32, device="cpu")
        ref = eng.serve_stream(_chaos_requests(), validate=True, **CHAOS_KW)
        _CHAOS.update(eng=eng, ref=ref)
    return _CHAOS["eng"], _CHAOS["ref"]


def _check(seed, loss, delay, jitter, out_start, out_len, spike_start,
           spike_len):
    eng, ref = _chaos_state()
    faults = FaultSchedule(
        seed=seed, loss_prob=loss, delay_ticks=delay, delay_jitter=jitter,
        outages=((out_start, out_start + out_len),) if out_len else (),
        spikes=((spike_start, spike_start + spike_len),) if spike_len else ())
    retry = RetryPolicy(ack_timeout_ticks=2, max_retries=2,
                        backoff_cap_ticks=4, breaker_threshold=2,
                        breaker_cooldown_ticks=4)
    reqs = _chaos_requests()
    out = eng.serve_stream(reqs, validate=True, faults=faults, retry=retry,
                           **CHAOS_KW)
    assert set(out) == {r.request_id for r in reqs}
    for rid, rec in out.items():
        assert rec["status"] in STATUSES and rec["status"] != "rejected"
        np.testing.assert_array_equal(rec["s_tokens"], ref[rid]["s_tokens"])
        if not rec["offloaded"]:
            assert rec["status"] == "ok" and not rec["served_remote"]
            np.testing.assert_array_equal(rec["tokens"], ref[rid]["tokens"])
        elif rec["status"] == "ok" and rec["served_remote"]:
            np.testing.assert_array_equal(rec["tokens"], ref[rid]["tokens"])
        else:
            assert rec["status"] in ("degraded_local", "dropped")
            np.testing.assert_array_equal(rec["tokens"], rec["s_tokens"])
    sched = eng._stream[1]
    sched.srt.pool.check_invariants()
    sched.lrt.pool.check_invariants()
    assert sched.srt.pool.held_slots == sched.lrt.pool.held_slots == []
    assert eng.stats["stream_compiles"] == 1


SWEEP = [
    (1, 1.0, 0, 0, 0, 0, 0, 0),
    (2, 0.0, 2, 2, 0, 0, 0, 0),
    (3, 0.0, 0, 0, 1, 6, 0, 0),
    (4, 0.0, 0, 0, 0, 0, 2, 5),
    (5, 0.25, 1, 2, 2, 4, 7, 3),
]


@pytest.mark.parametrize("params", SWEEP, ids=lambda p: f"seed{p[0]}")
def test_chaos_never_corrupts_seeded(params):
    _check(*params)


if HAVE_HYPOTHESIS:
    @given(
        seed=st.integers(0, 2**16),
        loss=st.sampled_from([0.0, 0.25, 1.0]),
        delay=st.integers(0, 2),
        jitter=st.integers(0, 2),
        out_start=st.integers(0, 10),
        out_len=st.integers(0, 8),
        spike_start=st.integers(0, 10),
        spike_len=st.integers(0, 6),
    )
    @settings(max_examples=6, deadline=None)
    def test_chaos_never_corrupts_hypothesis(seed, loss, delay, jitter,
                                             out_start, out_len, spike_start,
                                             spike_len):
        _check(seed, loss, delay, jitter, out_start, out_len, spike_start,
               spike_len)
