"""The port's telemetry, gate audit, SLO watchdog, flight recorder and
Chrome trace export, held against the reference's.

Re-states ``tests/test_telemetry.py``, ``tests/test_audit.py`` and
``tests/test_flight_recorder.py``:

* collectors on == collectors off, token for token, with one
  ``_host_fetch`` per tick and one scheduler build, over bf16 and int8
  pools;
* span trees for exactly the requests that terminate, with their records'
  statuses; on the same traffic and bridged params, each request's span
  kinds and the audit's decision stream equal the reference's (confidences
  within ``CONF_TOL``);
* one scripted event stream, on a fake clock, fed to both packages'
  collectors: histograms and quantiles, the Prometheus text (every key and
  family, the overflow bucket, label escaping) byte for byte, the audit's
  reliability bins against the reference's ``p_histogram`` oracle, per-class
  offload rates, regret, the Chrome trace, and flight-recorder dumps byte
  for byte in canonical JSON;
* a watchdog breach reaches the trace and the recorder; an invariant
  failure and a stall dump before they re-raise; the breaker-open dump is
  byte-equal across two fresh engines; the engine's counters never diverge
  from the scheduler's; ``serve_time`` is booked once per run.

``CONF_TOL`` = 5e-4 on max-prob confidences, as ``test_torch_stream.py``.
"""
import json
import math

import numpy as np
import pytest
import torch

from repro.core.calibrate import p_histogram
from repro.serving import audit as jaudit
from repro.serving import flight_recorder as jfr
from repro.serving import telemetry as jtel
from repro.serving import trace_export as jtrace
from repro.serving.batcher import Request as JRequest
from repro_torch.configs.base import HIConfig
from repro_torch.configs.registry import ARCHS
from repro_torch.serving import audit as taudit
from repro_torch.serving import engine as engine_mod
from repro_torch.serving import flight_recorder as tfr
from repro_torch.serving import telemetry as ttel
from repro_torch.serving import trace_export as ttrace
from repro_torch.serving.audit import (GateAudit, ReliabilityBins,
                                       SLOThresholds, SLOWatchdog)
from repro_torch.serving.batcher import AdmissionQueue, Request
from repro_torch.serving.engine import build_engine
from repro_torch.serving.faults import STATUSES, FaultSchedule, RetryPolicy
from repro_torch.serving.flight_recorder import FlightRecorder
from repro_torch.serving.scheduler import ContinuousScheduler
from repro_torch.serving.telemetry import (Histogram, SchedCounters,
                                           StatsView, Telemetry)
from test_torch_faults import _pair

STEPS = 3
CONF_TOL = 5e-4
KW = dict(buckets=(8, 16), num_slots=3, l_slots=2, page_size=8)
_STATE = {}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op torch thread: the reduced models' small ops run about
    as fast on it, and the suite's other workers keep their cores (the
    thread count is restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _requests(n=7, dropper=True, tclass=False, cls=Request):
    """tests/test_telemetry.py's traffic: two buckets, a zero-budget
    dropper, optional traffic classes."""
    rng = np.random.default_rng(42)
    reqs = []
    for i in range(n):
        ln = int(rng.integers(4, 16))
        reqs.append(cls(i, rng.integers(0, 500, ln).astype(np.int32),
                        max_new_tokens=STEPS,
                        latency_budget=0.0 if (dropper and i == 5) else None,
                        tclass=("interactive", "batch")[i % 2]
                        if tclass else ""))
    return reqs


def _eng(theta=0.6):
    if theta not in _STATE:
        _STATE[theta] = build_engine(
            ARCHS["qwen2-1.5b"].reduced(),
            HIConfig(theta=theta, capacity_factor=1.0),
            max_new_tokens=STEPS, cache_len=32, device="cpu")
    return _STATE[theta]


def _counting_fetch(monkeypatch):
    calls = []
    real = engine_mod._host_fetch
    monkeypatch.setattr(engine_mod, "_host_fetch",
                        lambda tree: (calls.append(1), real(tree))[1])
    return calls


# ---------------------------------------------------------------------------
# collectors on == off; one fetch per tick
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_collectors_token_identical_and_single_fetch(kv_dtype, monkeypatch):
    """tests/test_telemetry.py:85 / test_audit.py:116 — every collector on
    gives the tokens and confidences of every collector off, with one
    fetch per tick and no new scheduler build."""
    eng = _eng()
    base = eng.serve_stream(_requests(), validate=True, kv_dtype=kv_dtype,
                            **KW)
    sched = eng._stream[1]
    calls = _counting_fetch(monkeypatch)
    tel, aud = Telemetry(), GateAudit()
    wd = SLOWatchdog(SLOThresholds(ttft_p95=1e3))
    fr = FlightRecorder(capacity=8)
    ticks0, builds0 = eng.stats["stream_ticks"], eng.stats["stream_compiles"]
    on = eng.serve_stream(_requests(), validate=True, kv_dtype=kv_dtype,
                          telemetry=tel, audit=aud, watchdog=wd,
                          flight_recorder=fr, **KW)
    ticks = eng.stats["stream_ticks"] - ticks0
    assert len(calls) == ticks == len(tel.ticks) > 0
    assert eng.stats["stream_compiles"] == builds0
    assert eng._stream[1] is sched
    assert set(base) == set(on)
    for rid in base:
        np.testing.assert_array_equal(base[rid]["tokens"], on[rid]["tokens"])
        assert base[rid]["confidence"] == on[rid]["confidence"]
        assert base[rid]["status"] == on[rid]["status"]
    assert aud.decisions > 0 and not wd.breaches and not fr.dumps
    remote = sum(1 for r in on.values() if r["served_remote"])
    assert len([r for r in aud.records if r.kind == "l_agree"]) == remote \
        == aud.outcomes
    # the phases are host clocks around the tick's parts, in order
    for tick in tel.ticks:
        names = [p for p, _, _ in tick.segments]
        assert names == ["fault_tick", "build_operands", "dispatch",
                         "host_fetch", "postprocess"]
        assert all(b >= a for _, a, b in tick.segments)


def test_spans_for_exactly_the_terminating_requests():
    """tests/test_telemetry.py:57."""
    eng = _eng()
    tel = Telemetry()
    res = eng.serve_stream(_requests(), telemetry=tel, validate=True, **KW)
    assert set(tel.traces) == set(res)
    assert {r["status"] for r in res.values()} >= {"dropped"}
    for rid, rec in res.items():
        tr = tel.traces[rid]
        assert tr.complete and tr.status == rec["status"] in STATUSES
        kinds = [s.kind for s in tr.spans]
        assert kinds[0] == "queued" and kinds[-1] == "terminal"
        assert kinds.count("terminal") == 1 and "admitted" in kinds
        if rec["status"] == "ok" and rec["served_remote"]:
            assert "escalate_attempt" in kinds and "l_verify" in kinds
        assert all(math.isfinite(s.t1) for s in tr.spans)
    recs = {r["request_id"]: r for r in tel.request_records()}
    assert set(recs) == set(res)
    assert all(recs[r]["status"] == res[r]["status"] for r in res)


def test_spans_and_audit_match_the_reference():
    """The same traffic (every request escalates at theta 1.1) under the
    same seeded outage through both packages with every collector on: each
    request's span kinds, the audit's decision stream (rid, tier, kind,
    offload, theta in effect) and the breaker-open dump's counters are the
    reference's; confidences within ``CONF_TOL``."""
    jeng, teng = _pair(1.1)
    faults = dict(seed=5, outages=((1, 4),))
    retry = dict(ack_timeout_ticks=1, max_retries=1, breaker_threshold=2,
                 breaker_cooldown_ticks=2)
    from repro.serving import faults as jfaults
    from repro_torch.serving import faults as tfaults
    kw = dict(buckets=(8,), num_slots=2, page_size=8, validate=True)
    cols = {}
    for name, eng, mods, req in (
            ("jax", jeng, (jtel, jaudit, jfr, jfaults), JRequest),
            ("torch", teng, (ttel, taudit, tfr, tfaults), Request)):
        tel_m, aud_m, fr_m, f_m = mods
        tel, aud = tel_m.Telemetry(), aud_m.GateAudit()
        fr = fr_m.FlightRecorder(capacity=8)
        rng = np.random.default_rng(0)
        reqs = [req(i, rng.integers(0, 500, 8).astype(np.int32),
                    max_new_tokens=STEPS) for i in range(8)]
        out = eng.serve_stream(reqs, telemetry=tel, audit=aud,
                               flight_recorder=fr,
                               faults=f_m.FaultSchedule(**faults),
                               retry=f_m.RetryPolicy(**retry), **kw)
        cols[name] = (out, tel, aud, fr)
    (jout, jt, ja, jf), (tout, tt, ta, tf) = cols["jax"], cols["torch"]
    assert {r: v["status"] for r, v in tout.items()} == \
        {r: v["status"] for r, v in jout.items()}
    for rid in jout:
        assert [s.kind for s in tt.traces[rid].spans] == \
            [s.kind for s in jt.traces[rid].spans], rid
    assert len(ta.records) == len(ja.records) > 0
    for a, b in zip(ta.records, ja.records):
        assert (a.rid, a.tier, a.kind, a.offload, a.theta, a.ok) == \
            (b.rid, b.tier, b.kind, b.offload, b.theta, b.ok)
        assert abs(a.conf - b.conf) <= CONF_TOL
    assert [d["reason"] for d in tf.dumps] == [d["reason"] for d in jf.dumps]
    assert any(d["reason"] == "breaker_open" for d in tf.dumps)
    for a, b in zip(tf.dumps, jf.dumps):
        assert a["tick"] == b["tick"] and a["detail"] == b["detail"]
        assert [s["counters"] for s in a["ring"]] == \
            [s["counters"] for s in b["ring"]]
        assert [s["gauges"]["breaker_state"] for s in a["ring"]] == \
            [s["gauges"]["breaker_state"] for s in b["ring"]]


# ---------------------------------------------------------------------------
# one scripted event stream through both packages' collectors
# ---------------------------------------------------------------------------

def _script(tel_m, aud_m, fr_m, monkeypatch):
    """Drive one package's collectors through a fixed event stream on a
    fake clock; returns (telemetry, audit, recorder, watchdog)."""
    clock = iter(np.arange(0.0, 10.0, 1e-3).tolist())
    monkeypatch.setattr(tel_m, "_now", lambda: next(clock))
    tel, aud = tel_m.Telemetry(), aud_m.GateAudit(bins=20)
    counters = tel_m.SchedCounters(requests=5, offloaded=3, ticks=4,
                                   compiles=1, degraded_local=1)
    tel.counters, tel.audit = counters, aud
    wd = aud_m.SLOWatchdog(aud_m.SLOThresholds(
        ttft_p95=1e-3, queue_depth=1, offload_rate_max=0.1,
        min_requests=1))
    fr = fr_m.FlightRecorder(capacity=3)
    rng = np.random.default_rng(3)
    weird = 'we"ird\nclass\\x'
    for tick in range(4):
        tel.begin_tick(tick)
        for phase in ("fault_tick", "build_operands", "dispatch",
                      "host_fetch", "postprocess"):
            tel.mark(phase)
        for rid in range(3 * tick, 3 * tick + 3):
            tclass = ("interactive", "batch", weird)[rid % 3]
            tel.req_admitted("S", rid % 2, rid, 0.0, chunked=rid % 2 == 0)
            tel.req_chunk("S", rid % 2, rid, fed=8, keep=4)
            tel.req_decode("S", rid % 2, rid, 4)
            conf = float(rng.random())
            aud.decision(rid=rid, tier="S", tclass=tclass, kind="decode",
                         conf=conf, theta=0.6)
            aud.decision(rid=rid, tier="S", tclass=tclass, kind="request",
                         conf=conf, theta=0.6)
            # bin edges, 0 and 1 among the outcomes
            for c in (conf, tick / 4, 1.0, 0.0):
                aud.outcome(rid=rid, tier="L", tclass=tclass, conf=c,
                            theta=0.6, ok=bool(rng.random() < c),
                            kind="draft")
            if rid % 3 == 1:
                tel.req_esc_send(rid, -1, 0)
                tel.req_esc_end(rid, "arrived")
                tel.req_admitted("L", 0, rid, 0.0)
                tel.req_l_verify(0, rid, 2, 3)
            record = {"status": STATUSES[rid % 4], "ttft": 0.01 * (rid + 1),
                      "tokens": np.zeros(rid % 5 + 1),
                      "queue_wait_ticks": rid, "escalation_retries": rid % 2}
            tel.req_terminal(rid, record)
        gauges = {"free_pages@S": 10.0 - tick, "busy_slots@L": float(tick),
                  "l_queue_depth": float(tick), "breaker_state": 0.0}
        gauges.update(aud.gauge_values())
        tel.end_tick(gauges)
        breaches = wd.evaluate(tick, tel=tel, audit=aud, gauges=gauges)
        for b in breaches:
            tel.instant(f"slo_breach:{b['kind']}", **b)
        fr.record({"tick": tick, "gauges": gauges,
                   "counters": {"ticks": tick}})
        for b in breaches:
            fr.trigger(f"slo_breach:{b['kind']}", tick, b)
    tel.hists["ttft"].record(1e6)          # the overflow bucket
    return tel, aud, fr, wd


def test_scripted_stream_matches_reference_collectors(monkeypatch):
    """Both packages' collectors, fed the same events on the same clock,
    export the same bytes."""
    jt, ja, jf, jw = _script(jtel, jaudit, jfr, monkeypatch)
    tt, ta, tf, tw = _script(ttel, taudit, tfr, monkeypatch)
    # histograms and quantiles
    assert tt.histogram_summary() == jt.histogram_summary()
    for name, h in tt.hists.items():
        assert h.counts == jt.hists[name].counts
    # the whole Prometheus text: counters, phases, gauges, histograms with
    # the overflow folded into +Inf, the audit families, escaped labels
    txt = tt.prometheus_text()
    assert txt == jt.prometheus_text()
    assert 'tclass="we\\"ird\\nclass\\\\x"' in txt
    assert 'we"ird\nclass' not in txt
    h = tt.hists["ttft"]
    finite = [float(ln.split('le="')[1].split('"')[0])
              for ln in txt.splitlines()
              if ln.startswith("hi_ttft_seconds_bucket") and "+Inf" not in ln]
    assert finite and max(finite) <= h.upper_edge(h.n_buckets - 2)
    for fam in ("hi_requests_total", "hi_audit_ece", "hi_gauge",
                "hi_tick_phase_seconds_total", "hi_audit_theta_margin"):
        assert f"# HELP {fam}" in txt and f"# TYPE {fam}" in txt
    assert ttel.escape_label('a"b\\c\nd') == jtel.escape_label('a"b\\c\nd')
    # audit: bins against the oracle, classes, regret, records
    truthed = [r for r in ta.records if r.ok is not None]
    oracle = p_histogram(np.array([r.conf for r in truthed]),
                         np.array([r.ok for r in truthed], np.float32))
    np.testing.assert_array_equal(ta.overall.correct, oracle["correct"])
    np.testing.assert_array_equal(ta.overall.incorrect, oracle["incorrect"])
    assert ta.summary() == ja.summary()
    assert list(ta.records) == [tuple(r) for r in ja.records]
    for t in ta.classes:
        assert ta.offload_rate(t) == ja.offload_rate(t)
        np.testing.assert_array_equal(ta.reliability(t)["correct"],
                                      ja.reliability(t)["correct"])
    assert ta.gauge_values() == ja.gauge_values()
    # watchdog breaches, the Chrome trace and the recorder's dumps
    assert tw.breaches == jw.breaches and tw.breaches
    td, jd = ttrace.chrome_trace(tt), jtrace.chrome_trace(jt)
    assert td["traceEvents"] == jd["traceEvents"]
    assert [tfr.FlightRecorder.dump_json(d) for d in tf.dumps] == \
        [jfr.FlightRecorder.dump_json(d) for d in jf.dumps]
    assert tf.dumps and len(tf.ring) == 3


def test_reliability_bins_match_p_histogram_oracle():
    """tests/test_audit.py:62 — the streaming bins and ECE against the
    reference's numpy oracle, bin edges, 0 and 1 included."""
    rng = np.random.default_rng(0)
    conf = np.concatenate([rng.random(500), np.linspace(0.0, 1.0, 21),
                           [0.0, 1.0]])
    ok = rng.random(conf.size) < conf
    bins, jbins = ReliabilityBins(bins=20), jaudit.ReliabilityBins(bins=20)
    for c, o in zip(conf, ok):
        bins.record(float(c), bool(o))
        jbins.record(float(c), bool(o))
    oracle = p_histogram(conf, ok.astype(np.float32), bins=20)
    np.testing.assert_array_equal(bins.edges, oracle["edges"])
    np.testing.assert_array_equal(bins.correct, oracle["correct"])
    np.testing.assert_array_equal(bins.incorrect, oracle["incorrect"])
    assert bins.ece() == jbins.ece() and bins.count == conf.size


def test_histogram_buckets_and_quantiles():
    """tests/test_telemetry.py:209, against the reference's histogram."""
    vals = (0.0005, 0.002, 0.002, 0.004, 0.008, 5.0, float("nan"))
    h, jh = Histogram(lo=1e-3, hi=10.0), jtel.Histogram(lo=1e-3, hi=10.0)
    for v in vals:
        h.record(v)
        jh.record(v)
    s = h.summary()
    assert s == jh.summary() and s["count"] == 6
    assert 0.001 <= s["p50"] <= 0.004 and 1.0 <= s["p99"] <= 5.0
    assert s["p50"] <= s["p95"] <= s["p99"]
    assert Histogram().summary() == {"count": 0}
    assert math.isnan(Histogram().quantile(0.5))


def test_stats_view_dict_api():
    """tests/test_telemetry.py:194."""
    c = SchedCounters()
    v = StatsView(c)
    v["ticks"] += 3
    assert c.ticks == 3 and v["ticks"] == 3
    assert "ticks" in v and len(v) == len(dict(v))
    assert dict(**v)["ticks"] == 3
    with pytest.raises(KeyError):
        v["not_a_counter"]
    with pytest.raises(KeyError):
        v["not_a_counter"] = 1
    with pytest.raises(TypeError):
        del v["ticks"]


def test_flight_recorder_units(tmp_path):
    """tests/test_flight_recorder.py:52 and :66 — capacity, the bounded
    ring, ``path`` and canonical JSON."""
    with pytest.raises(ValueError, match="capacity"):
        FlightRecorder(capacity=0)
    fr = FlightRecorder(capacity=4)
    for i in range(100):
        fr.record({"tick": i})
    assert [s["tick"] for s in fr.ring] == [96, 97, 98, 99]
    dump = fr.trigger("test", 99)
    assert len(dump["ring"]) == 4 and dump["seq"] == 0 and fr.last_dump is dump
    p = tmp_path / "dump.json"
    fr = FlightRecorder(capacity=2, path=str(p))
    fr.record({"tick": 0, "b": 1.0, "a": 2})
    d1 = fr.trigger("first", 0)
    d2 = fr.trigger("second", 1, {"why": "because"})
    assert json.loads(p.read_text())["reason"] == "second"
    assert [d["seq"] for d in fr.dumps] == [0, 1]
    assert d2["detail"] == {"why": "because"}
    assert FlightRecorder.dump_json(d1) == \
        FlightRecorder.dump_json(json.loads(FlightRecorder.dump_json(d1)))


# ---------------------------------------------------------------------------
# exporters, watchdog and recorder on real port runs
# ---------------------------------------------------------------------------

def test_prometheus_snapshot_and_chrome_trace(tmp_path):
    """tests/test_telemetry.py:234 and :252."""
    eng = _eng()
    tel = Telemetry()
    res = eng.serve_stream(_requests(), telemetry=tel, validate=True, **KW)
    txt = tel.prometheus_text()
    for key in ("hi_requests_total", "hi_degraded_local_total",
                "hi_ticks_total",
                'hi_tick_phase_seconds_total{phase="dispatch"}',
                'hi_tick_phase_seconds_total{phase="host_fetch"}',
                'hi_gauge{name="free_pages",tier="S"}',
                'hi_gauge{name="breaker_state"}',
                "hi_ttft_seconds_count", 'hi_ttft_seconds_bucket{le="+Inf"}',
                "hi_tpot_seconds_count", "hi_queue_wait_ticks_count"):
        assert key in txt, key
    path = tmp_path / "trace.json"
    doc = ttrace.write_chrome_trace(tel, str(path))
    assert json.loads(path.read_text())["traceEvents"]
    ev = doc["traceEvents"]
    terminals = {e["args"]["request_id"]: e for e in ev
                 if e["ph"] == "i" and e["name"].startswith("terminal:")}
    assert set(terminals) == set(res)
    for rid, rec in res.items():
        assert terminals[rid]["name"] == f"terminal:{rec['status']}"
    phases = {e["name"] for e in ev if e.get("pid") == 0 and e["ph"] == "X"}
    assert {"build_operands", "dispatch", "host_fetch"} <= phases
    remote = {r for r, rec in res.items() if rec["served_remote"]}
    assert remote and remote <= {e["id"] for e in ev if e["ph"] == "s"}
    assert remote <= {e["id"] for e in ev if e["ph"] == "f"}
    assert any(e["ph"] == "C" for e in ev)
    assert min(e["ts"] for e in ev if "ts" in e) >= 0.0


def test_watchdog_breaches_reach_trace_and_recorder():
    """tests/test_audit.py:173."""
    eng = _eng()
    tel, aud = Telemetry(), GateAudit()
    wd = SLOWatchdog(SLOThresholds(queue_depth=0, offload_rate_max=0.0,
                                   min_requests=1))
    fr = FlightRecorder(capacity=8)
    res = eng.serve_stream(_requests(), telemetry=tel, audit=aud,
                           watchdog=wd, flight_recorder=fr, validate=True,
                           **KW)
    assert any(r["offloaded"] for r in res.values())
    assert "offload_rate" in {b["kind"] for b in wd.breaches}
    assert any(n.startswith("slo_breach:offload_rate")
               for _, n, _ in tel.events)
    ev = ttrace.chrome_trace(tel)["traceEvents"]
    assert any(e["ph"] == "i" and e.get("cat") == "slo" for e in ev)
    assert any(e["ph"] == "C" and e["name"] == "audit_ece" for e in ev)
    assert fr.dumps and fr.last_dump["reason"].startswith("slo_breach:")
    assert all("audit_ece" in s["gauges"] for s in fr.last_dump["ring"])
    assert all("serve_time" not in s["counters"]
               for s in fr.last_dump["ring"])


def test_per_tclass_offload_rates_match_records():
    """tests/test_audit.py:145."""
    eng = _eng()
    aud = GateAudit()
    res = eng.serve_stream(_requests(tclass=True), validate=True, audit=aud,
                           **KW)
    by_class = {}
    for r in _requests(tclass=True):
        by_class.setdefault(r.tclass, []).append(res[r.request_id])
    assert set(aud.classes) == set(by_class)
    for t, recs in by_class.items():
        off = sum(1 for r in recs if r["offloaded"])
        assert aud.classes[t].requests == len(recs)
        assert aud.offload_rate(t) == pytest.approx(off / len(recs))
    assert aud.ece("no-such-class") == 0.0


def test_breaker_open_dump_deterministic_across_runs():
    """tests/test_flight_recorder.py:112 — a seeded outage's breaker-open
    dump is byte-equal across two fresh engines and shows the OPEN
    transition."""
    dumps = []
    for _ in range(2):
        eng = _fresh(theta=1.1)
        fr = FlightRecorder(capacity=8)
        eng.serve_stream(
            _faults_reqs(8), validate=True,
            faults=FaultSchedule(seed=5, outages=((1, 4),)),
            retry=RetryPolicy(ack_timeout_ticks=1, max_retries=1,
                              breaker_threshold=2, breaker_cooldown_ticks=2),
            flight_recorder=fr, buckets=(8,), num_slots=2, page_size=8)
        assert eng.stats["breaker_opens"] >= 1
        dumps.append([FlightRecorder.dump_json(d) for d in fr.dumps])
        opens = [d for d in fr.dumps if d["reason"] == "breaker_open"]
        assert opens and opens[0]["detail"]["opens"] == 1
        assert any(s["gauges"].get("breaker_state") == 1.0
                   for s in opens[0]["ring"])
    assert dumps[0] == dumps[1]


def _fresh(theta):
    return build_engine(ARCHS["qwen2-1.5b"].reduced(),
                        HIConfig(theta=theta, capacity_factor=1.0),
                        max_new_tokens=STEPS, cache_len=32, device="cpu")


def _faults_reqs(n):
    rng = np.random.default_rng(0)
    vocab = ARCHS["qwen2-1.5b"].reduced().vocab_size
    return [Request(i, rng.integers(0, vocab, 8).astype(np.int32),
                    max_new_tokens=STEPS) for i in range(n)]


def test_invariant_failure_and_stall_dump_before_reraising(monkeypatch):
    """tests/test_flight_recorder.py:136 and :156."""
    kw = dict(buckets=(8,), num_slots=2, page_size=8)
    eng = _fresh(theta=1.1)
    fr = FlightRecorder(capacity=4)
    eng.serve_stream(_faults_reqs(2), validate=True, flight_recorder=fr, **kw)
    sched = eng._stream[1]

    def boom():
        raise AssertionError("injected invariant violation")

    with monkeypatch.context() as m:
        m.setattr(sched.srt.pool, "check_invariants", boom)
        with pytest.raises(AssertionError, match="injected invariant"):
            eng.serve_stream(_faults_reqs(2), validate=True,
                             flight_recorder=fr, **kw)
    assert fr.last_dump["reason"] == "invariant_failure"
    assert "injected invariant" in fr.last_dump["detail"]["error"]
    eng = _fresh(theta=1.1)
    eng.serve_stream(_faults_reqs(1), flight_recorder=fr, **kw)
    sched = eng._stream[1]
    monkeypatch.setattr(sched, "_stall_limit", lambda: 0)
    with pytest.raises(RuntimeError, match="stalled"):
        eng.serve_stream(_faults_reqs(1),
                         faults=FaultSchedule(seed=1, delay_ticks=6),
                         flight_recorder=fr, **kw)
    assert fr.last_dump["reason"] == "stall"
    assert fr.last_dump["detail"]["idle_ticks"] > 0
    assert fr.last_dump["detail"]["in_flight"] >= 1


def test_ring_bounded_under_long_run():
    """tests/test_flight_recorder.py:91."""
    eng = _fresh(theta=0.6)
    fr = FlightRecorder(capacity=4)
    eng.serve_stream(_faults_reqs(10), validate=True, flight_recorder=fr,
                     buckets=(8,), num_slots=2, page_size=8)
    ticks = eng.stats["stream_ticks"]
    assert ticks > 4
    assert [s["tick"] for s in fr.ring] == list(range(ticks - 4, ticks))
    assert not fr.dumps


# ---------------------------------------------------------------------------
# counters
# ---------------------------------------------------------------------------

def test_engine_view_never_diverges_from_scheduler():
    """tests/test_telemetry.py:151 — the engine reads the scheduler's
    typed counters live: engine total = retired base + scheduler."""
    eng = _eng()
    eng.serve_stream(_requests(), validate=True, **KW)
    sched = eng._stream[1]
    base0 = dict(eng.stats)
    eng.serve_stream(_requests(), validate=True,
                     faults=FaultSchedule(seed=7, loss_prob=1.0),
                     retry=RetryPolicy(ack_timeout_ticks=2, max_retries=1,
                                       backoff_cap_ticks=2,
                                       breaker_threshold=2,
                                       breaker_cooldown_ticks=4), **KW)
    assert eng._stream[1] is sched
    for k in ("requests", "offloaded", "dropped", "degraded_local",
              "rejected", "breaker_open_ticks", "breaker_opens",
              "esc_retries", "esc_lost"):
        assert eng.stats[k] - base0[k] >= 0
    for ek, sk in (("requests", "requests"), ("stream_ticks", "ticks"),
                   ("degraded_local", "degraded_local"),
                   ("esc_retries", "esc_retries"), ("esc_lost", "esc_lost")):
        assert eng.stats[ek] == getattr(eng.counters, ek) + sched.stats[sk]
    assert sched.stats["degraded_local"] > 0
    before = eng.stats["requests"]
    eng.stats["requests"] += 5
    assert eng.stats["requests"] == before + 5
    eng.stats["requests"] -= 5


def test_serve_time_single_entry_on_exception(monkeypatch):
    """tests/test_telemetry.py:113 — ``serve_time`` is booked once per run,
    also when the run dies mid-loop."""
    eng = _eng()
    sched = ContinuousScheduler(
        eng.s, eng.l, HIConfig(theta=0.0, capacity_factor=1.0),
        max_prompt_len=16, max_new_tokens=STEPS, num_slots=2, l_slots=1,
        page_size=8, decode_block=2, prefix_sharing=False)
    rng = np.random.default_rng(3)
    queue = AdmissionQueue(buckets=(8, 16))
    queue.submit(Request(0, rng.integers(0, 500, 8).astype(np.int32),
                         max_new_tokens=STEPS))
    assert sched.stats["serve_time"] == 0.0

    def boom(theta):
        raise RuntimeError("injected dispatch failure")

    monkeypatch.setattr(sched, "_dispatch", boom)
    with pytest.raises(RuntimeError, match="injected"):
        sched.run(queue)
    t_fail = sched.stats["serve_time"]
    assert t_fail > 0.0
    monkeypatch.undo()
    queue2 = AdmissionQueue(buckets=(8, 16))
    queue2.submit(Request(1, rng.integers(0, 500, 8).astype(np.int32),
                          max_new_tokens=STEPS))
    sched.run(queue2)
    assert sched.stats["serve_time"] > t_fail


def test_telemetry_under_active_faults():
    """tests/test_chaos.py:132 — with telemetry on under an active
    schedule every request gets a complete span tree whose terminal status
    is its record's, and the escalation spans carry the attempts."""
    eng = _eng()
    tel = Telemetry()
    out = eng.serve_stream(
        _requests(), validate=True, telemetry=tel,
        faults=FaultSchedule(seed=5, loss_prob=0.25, delay_ticks=1,
                             delay_jitter=2, outages=((2, 6),),
                             spikes=((7, 10),)),
        retry=RetryPolicy(ack_timeout_ticks=2, max_retries=2,
                          backoff_cap_ticks=4, breaker_threshold=2,
                          breaker_cooldown_ticks=4), **KW)
    assert set(tel.traces) == set(out)
    for rid, rec in out.items():
        tr = tel.traces[rid]
        assert tr.complete and tr.status == rec["status"]
        kinds = [s.kind for s in tr.spans]
        assert kinds.count("terminal") == 1
        if rec["escalation_retries"]:
            assert kinds.count("escalate_attempt") >= \
                rec["escalation_retries"]
    assert tel.ticks and all(t.t1 >= t.t0 for t in tel.ticks)
