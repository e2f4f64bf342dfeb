"""The scheduler's lane spans inside a tick's ``dispatch``, their profiler
ranges, and the chunk lane's fill counters, on the port alone (reduced
qwen2-1.5b on the CPU):

* every tick's lane spans lie inside its ``dispatch`` segment, in order and
  without overlap, and name the tick that ran them;
* each tier's lanes per tick are the ones its host flags say ran, and the
  ``lane_ticks`` deltas count them; ``lane_time`` sums them;
* under a CPU ``torch.profiler``, the ``hi.*`` ranges lie where the spans
  do, within 0.5 ms after ``hibench.trace.Clock``'s shift;
* with telemetry off, no ``record_function`` range and no lane context is
  made; on, every range opened is closed;
* the chunk counters equal the sum of ``chunk_sched``'s keeps and the
  lane's width x C per tick it ran;
* the Chrome trace draws the lanes on a thread of their own, and each
  request's ``prefill_chunk`` / ``decode_block`` span names the tick and
  lane that ran it;

on the plain path (prefix sharing with COW, and the chunk lane), the
speculative draft and verify, and the mesh tick at a (1, 1) mesh.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hibench import trace as hb_trace
from repro_torch.configs.base import HIConfig
from repro_torch.configs.registry import ARCHS
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.serving import scheduler as sched_mod
from repro_torch.serving import telemetry as tel_mod
from repro_torch.serving import trace_export
from repro_torch.serving.batcher import Request
from repro_torch.serving.engine import build_engine
from repro_torch.serving.telemetry import Telemetry

STEPS = 4
PATHS = ("sharing", "chunk", "spec", "mesh")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op torch thread: the reduced models' small ops run about
    as fast on it, and the suite's other workers keep their cores (the
    thread count is restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    return ARCHS["qwen2-1.5b"].reduced()


def _requests(path):
    cfg = _cfg()
    rng = np.random.default_rng(3)
    if path == "sharing":
        # a shared 8-token prefix and repeats: the 12 bucket's partial tail
        # page makes restores copy-on-write
        base = rng.integers(0, cfg.vocab_size, 8).astype(np.int32)
        tails = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                 for n in (4, 8, 8)]
        order = [0, 1, 2, 0, 1, 2, 0, 1]
        return [Request(i, np.concatenate([base, tails[k]]),
                        max_new_tokens=STEPS) for i, k in enumerate(order)]
    return [Request(i, rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                    max_new_tokens=STEPS)
            for i, n in enumerate([24, 8, 16, 24, 12])]


def _serve(path, telemetry=None):
    """One stream on ``path`` with every request escalated (theta above any
    max-prob confidence); returns (engine, records)."""
    eng = build_engine(_cfg(), HIConfig(theta=1.1, capacity_factor=1.0),
                       max_new_tokens=STEPS, cache_len=48, device="cpu")
    kw = dict(num_slots=2, page_size=8, validate=True, telemetry=telemetry)
    if path == "sharing":
        kw.update(buckets=(12, 16), prefix_sharing=True)
    else:
        kw.update(buckets=(8, 16, 24), chunk_prefill=True, chunk_size=8)
    if path == "spec":
        kw.update(speculative=True, decode_block=3)
    if path == "mesh":
        kw.update(mesh=make_serving_mesh(1, 1, device="cpu"))
    return eng, eng.serve_stream(_requests(path), **kw)


def _flag_log(monkeypatch):
    """Each ``tick_inputs`` call: (runtime, its flags, its chunk rows)."""
    log = []
    real = sched_mod._TierRuntime.tick_inputs

    def logged(self, s_max):
        arrays, flags = real(self, s_max)
        log.append((self, flags, list(self.chunk_sched)))
        return arrays, flags
    monkeypatch.setattr(sched_mod._TierRuntime, "tick_inputs", logged)
    return log


def _expected(flags, role):
    """The lanes a tier's tick runs, in order, from its host flags."""
    lanes = []
    if flags["any_admit"]:
        lanes += ["cow"] * bool(flags.get("any_cow")) + ["admit"]
    lanes += ["chunk"] * bool(flags.get("any_chunk"))
    if flags["any_live"]:
        lanes.append("verify" if role == "spec_l" else "live")
    return lanes


@pytest.mark.parametrize("path", PATHS)
def test_lanes_follow_the_host_flags_inside_dispatch(path, monkeypatch):
    log = _flag_log(monkeypatch)
    tel = Telemetry()
    eng, _ = _serve(path, tel)
    sched = eng._stream[1]
    spec = path == "spec"
    rts = (*sched.srts, sched.lrt)
    assert len(tel.ticks) == eng.stats["stream_ticks"] \
        == len(log) // len(rts) > 0
    seen = {(rt.name, lane): 0 for rt in rts for lane in sched_mod.LANES}
    for i, tick in enumerate(tel.ticks):
        calls = log[i * len(rts):(i + 1) * len(rts)]
        s_flags, l_flags = calls[0][1], calls[-1][1]
        want = [(sched.srt.name, x)
                for x in _expected(s_flags, "spec_s" if spec else "plain")]
        want += [("L", x)
                 for x in _expected(l_flags, "spec_l" if spec else "plain")]
        if spec and s_flags["any_live"]:
            want.append(("S", "verify"))       # the S tier's rollback
        assert [(sp.tier, sp.lane) for sp in tick.lanes] == want, i
        (d0, d1), = [(a, b) for p, a, b in tick.segments if p == "dispatch"]
        at = d0
        for sp in tick.lanes:
            assert sp.tick == tick.index
            assert at <= sp.t0 <= sp.t1 <= d1
            at = sp.t1
        for tier, lane in want:
            seen[(tier, "live" if lane == "verify" else lane)] += \
                not (spec and tier == "S" and lane == "verify")
    for rt in rts:
        for lane in ("cow", "admit", "chunk", "live"):
            assert rt.lane_ticks[lane] == seen[(rt.name, lane)], (rt.name,
                                                                  lane)
    lanes = {sp.lane for t in tel.ticks for sp in t.lanes}
    assert {"admit", "live" if not spec else "verify"} <= lanes
    assert ("cow" in lanes) == (path == "sharing")
    assert ("chunk" in lanes) == (path != "sharing")
    for key, total in tel.lane_time.items():
        assert total == pytest.approx(sum(
            sp.t1 - sp.t0 for t in tel.ticks for sp in t.lanes
            if f"{sp.tier}.{sp.lane}" == key))


@pytest.mark.parametrize("path", PATHS)
def test_chunk_fill_counts_the_scheduled_keeps(path, monkeypatch):
    log = _flag_log(monkeypatch)
    eng, _ = _serve(path)
    for rt in (*eng._stream[1].srts, eng._stream[1].lrt):
        rows = [sched for r, _, sched in log if r is rt]
        assert rt.chunk_tokens == sum(k for row in rows for _, k, _ in row)
        assert rt.chunk_positions == rt.chunk_size * sum(
            sched_mod.chunk_lane_width(len(row), rt.chunk_width)
            for row in rows if row)
        assert (rt.chunk_tokens > 0) == (path != "sharing")
        assert rt.chunk_tokens <= rt.chunk_positions


class _Counting:
    """Stands for ``record_function``: counts ranges opened and closed."""
    opened, closed = [], []

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        _Counting.opened.append(self.name)

    def __exit__(self, *exc):
        _Counting.closed.append(self.name)


@pytest.mark.parametrize("path", PATHS)
def test_no_range_and_no_lane_while_telemetry_is_off(path, monkeypatch):
    made = []
    lane_cls = tel_mod._Lane
    monkeypatch.setattr(tel_mod, "record_function", _Counting)
    monkeypatch.setattr(tel_mod, "_Lane",
                        lambda *a: made.append(a) or lane_cls(*a))
    _Counting.opened, _Counting.closed = [], []
    _serve(path)
    assert _Counting.opened == [] and made == []
    tel = Telemetry()
    _serve(path, tel)
    spans = [sp for t in tel.ticks for sp in t.lanes]
    opened = _Counting.opened
    assert sorted(opened) == sorted(_Counting.closed)
    assert opened.count("hi.dispatch") == len(tel.ticks)
    assert opened.count("hi.tick") >= len(tel.ticks)
    assert [n for n in opened if n.count(".") == 2] == \
        [f"hi.{sp.tier}.{sp.lane}" for sp in spans]
    assert len(made) == len(spans) > 0


@pytest.mark.parametrize("path", ("chunk", "spec"))
def test_profiler_ranges_lie_on_the_spans(path):
    """The ``hi.*`` ranges of a CPU profile, shifted by the harness's
    clock marker, lie within 0.5 ms of telemetry's spans and phases."""
    tel, clock = Telemetry(), hb_trace.Clock()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with clock.marker():
            pass
        _serve(path, tel)
    events = prof.profiler.kineto_results.events()
    off = clock.offset_ns(events)
    got = {}
    for e in events:
        if e.is_user_annotation() and e.name().startswith("hi."):
            got.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    want = {"hi.tick": [(t.t0, t.t1) for t in tel.ticks],
            "hi.dispatch": [(a, b) for t in tel.ticks
                            for p, a, b in t.segments if p == "dispatch"]}
    for t in tel.ticks:
        for sp in t.lanes:
            want.setdefault(f"hi.{sp.tier}.{sp.lane}", []).append(
                (sp.t0, sp.t1))
    assert set(got) == set(want) and len(want) > 3
    for name, spans in want.items():
        ranges = sorted(got[name])
        assert len(ranges) == len(spans), name
        for (r0, r1), (s0, s1) in zip(ranges, sorted(spans)):
            assert abs(r0 - (s0 * 1e9 + off)) <= 0.5e6, name
            assert abs(r1 - (s1 * 1e9 + off)) <= 0.5e6, name


@pytest.mark.parametrize("path", PATHS)
def test_chrome_trace_draws_lanes_and_their_requests(path):
    tel = Telemetry()
    _serve(path, tel)
    spans = {(t.index, sp.tier, sp.lane) for t in tel.ticks
             for sp in t.lanes}
    ev = trace_export.chrome_trace(tel)["traceEvents"]
    lane_ev = [e for e in ev if e.get("cat") == "lane"]
    assert len(lane_ev) == sum(len(t.lanes) for t in tel.ticks) > 0
    assert all(e["pid"] == 0 and e["tid"] == 1 and e["ph"] == "X"
               for e in lane_ev)
    assert {(e["args"]["tick"],) + tuple(e["name"].split(".")) for e in
            lane_ev} == spans
    assert any(e["ph"] == "M" and e["pid"] == 0 and e.get("tid") == 1
               and e["args"]["name"] == "lanes" for e in ev)
    caused = 0
    for tr in tel.traces.values():
        for s in tr.spans:
            if s.kind in ("prefill_chunk", "decode_block") or (
                    s.kind == "l_verify" and "lane" in s.args):
                assert (s.args["tick"], s.tier, s.args["lane"]) in spans
                caused += 1
    assert caused > 0
    req = [e for e in ev if e.get("cat") == "request"
           and e["name"].startswith(("prefill_chunk[", "decode_block["))]
    assert req and all({"tick", "lane"} <= set(e["args"]) for e in req)
