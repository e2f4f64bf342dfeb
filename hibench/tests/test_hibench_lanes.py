"""The per-lane reduction (``hibench/lanes.py``) on a hand-made event list
with known launches, kernels, runtime calls and gaps, the five lane
metrics' readers, and the toy cell's traced run on the CPU with the lanes
read beside it."""
from pathlib import Path
from types import SimpleNamespace

import pytest

from hibench import lanes
from hibench import program
from hibench import run
from hibench import trace as tr
from hibench.tests import tiny

BENCH = Path(__file__).resolve().parents[1]
NEW = tuple(lanes.METRICS)
DEVICE = ("kernels_per_tick", "dispatch_runtime_ms", "l_chunk_device_ms",
          "decode_idle_share")


class _Dev:
    def __init__(self, name):
        self.name = name


class _Ev:
    """A kineto event as ``reduce`` reads one."""

    def __init__(self, name, a, b, device="CPU", corr=0, note=False):
        self._v = (name, a, b, _Dev(device), corr, note)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]


class _Clock:
    def offset_ns(self, events):
        return 0


def _range(name, a, b):
    return _Ev(name, a, b, note=True)


# one tick over a 1,000 ns window: the tick's phases (host clock, seconds),
# its ranges, runtime calls and the device operations they launch
SEGMENTS = [(p, a / 1e9, b / 1e9) for p, a, b in (
    ("fault_tick", 0, 100), ("build_operands", 100, 200),
    ("dispatch", 200, 700), ("host_fetch", 700, 900),
    ("postprocess", 900, 1000))]
EVENTS = [
    _range("hibench.window", 0, 1000),
    _range("hi.tick", 1, 999), _range("hi.dispatch", 210, 690),
    _range("hi.S.live", 220, 400), _range("hi.L.chunk", 400, 650),
    # the device's copy of a range, and an ATen op: neither is read
    _Ev("hi.S.live", 240, 300, "CUDA", note=True),
    _Ev("aten::mm", 230, 245),
    # the upload in build_operands
    _Ev("cudaMemcpyAsync", 150, 160, corr=1),
    _Ev("Memcpy HtoD (Pinned -> Device)", 160, 170, "CUDA", corr=1),
    # a kernel of the S decode lane, one of the L chunk lane that runs on
    # into host_fetch, one launched in dispatch outside the lanes
    _Ev("cudaLaunchKernel", 230, 240, corr=2),
    _Ev("k_live", 240, 300, "CUDA", corr=2),
    _Ev("cuLaunchKernel", 410, 420, corr=3),
    _Ev("k_chunk", 420, 800, "CUDA", corr=3),
    _Ev("cudaLaunchKernel", 660, 665, corr=6),
    _Ev("k_rest", 665, 670, "CUDA", corr=6),
    # the fetch: a copy, and the sync that waits for it
    _Ev("cudaMemcpyAsync", 705, 715, corr=5),
    _Ev("cudaStreamSynchronize", 720, 850, corr=4),
    _Ev("Memcpy DtoH (Device -> Pinned)", 800, 820, "CUDA", corr=5),
    # a device operation whose launch the trace lacks
    _Ev("k_orphan", 950, 960, "CUDA", corr=99),
]
ROWS = {  # host, device, kernels, runtime, idle (ns)
    "S.live": (180, 60, 1, 10, 120),
    "L.chunk": (250, 380, 1, 10, 20),
    "dispatch": (70, 5, 1, 5, 20),
    "build_operands": (100, 10, 0, 10, 90),
    "host_fetch": (200, 20, 0, 140, 80),
    "fault_tick": (100, 0, 0, 0, 100),
    "postprocess": (100, 0, 0, 0, 90),
    lanes.UNATTRIBUTED: (0, 10, 1, 0, 0),
}


def test_reduce_puts_each_launch_and_gap_to_its_lane():
    got = lanes.reduce(EVENTS, "hibench.window", _Clock(), SEGMENTS)
    assert got["ticks"] == 1 and got["device_ops"] == 6
    assert got["window_s"] == pytest.approx(1e-6)
    assert got["busy_s"] == pytest.approx(480e-9)
    assert got["attributed_share"] == pytest.approx(470 / 480)
    assert got["lane_host_s"] == pytest.approx(430e-9)
    assert got["dispatch_host_s"] == pytest.approx(480e-9)
    assert got["dispatch"] == pytest.approx(
        {"kernels": 3, "runtime_s": 25e-9, "device_s": 445e-9})
    assert set(got["rows"]) == set(ROWS)
    for name, (host, dev, kernels, rt, idle) in ROWS.items():
        assert got["rows"][name] == pytest.approx(
            {"host_s": host * 1e-9, "device_s": dev * 1e-9,
             "kernels": kernels, "runtime_s": rt * 1e-9,
             "idle_s": idle * 1e-9}), name
    # the idle gaps, and the host time, cover the window once
    assert sum(r["idle_s"] for r in got["rows"].values()) + got["busy_s"] \
        == pytest.approx(got["window_s"])
    assert sum(r["host_s"] for r in got["rows"].values()) == \
        pytest.approx(got["window_s"])
    assert got["calls"]["host_fetch"] == pytest.approx({
        "cudaMemcpyAsync": [1, 10e-9, 0.0],
        "cudaStreamSynchronize": [1, 130e-9, 0.0]})
    assert set(got["calls"]["L.chunk"]) == {"cuLaunchKernel"}
    text = lanes.table(got)
    assert "L.chunk" in text.splitlines()[2] and "S.live" in text


def test_overlay_carves_the_lanes_out_of_the_phases():
    base = [("a", 0, 10), ("b", 10, 20)]
    top = [("x", 2, 4), ("y", 8, 12), ("z", 15, 20)]
    assert lanes.overlay(base, top) == [
        ("a", 0, 2), ("x", 2, 4), ("a", 4, 8), ("y", 8, 12), ("b", 12, 15),
        ("z", 15, 20)]
    assert tr.attribute([(1, 16)], lanes.overlay(base, top)) == {
        "a": 5, "x": 2, "y": 4, "b": 3, "z": 1}


def _read(name, ctx):
    return run.read_metric(BENCH / "metrics" / f"{name}.py", ctx)


def test_lane_metric_readers():
    ctx = SimpleNamespace(
        lanes=lanes.reduce(EVENTS, "hibench.window", _Clock(), SEGMENTS),
        chunk_fill={"tokens": 300, "positions": 512})
    assert _read("chunk_fill_share", ctx) == pytest.approx(58.59375)
    assert _read("kernels_per_tick", ctx) == 3
    assert _read("dispatch_runtime_ms", ctx) == pytest.approx(25e-6)
    assert _read("l_chunk_device_ms", ctx) == pytest.approx(380e-6)
    assert _read("decode_idle_share", ctx) == pytest.approx(12.0)
    # nothing to read: run.py's context, a trace without device work, a
    # lane that never ran, a chunk lane that never ran
    quiet = lanes.reduce(
        [e for e in EVENTS if e.device_type().name == "CPU"],
        "hibench.window", _Clock(), SEGMENTS)
    no_chunk = lanes.reduce(
        [e for e in EVENTS if e.name() != "hi.L.chunk"], "hibench.window",
        _Clock(), SEGMENTS)
    assert _read("l_chunk_device_ms",
                 SimpleNamespace(lanes=no_chunk)) is None
    for ctx in (SimpleNamespace(window_s=1.0, trace=None),
                SimpleNamespace(lanes=quiet,
                                chunk_fill={"tokens": 0, "positions": 0})):
        for name in NEW:
            assert _read(name, ctx) is None, name


def test_tiny_traced_run_reads_the_chunk_fill(monkeypatch):
    """On the CPU the lanes' host side and the chunk fill read, the device
    metrics do not, and ``run.execute``'s own result is what it is without
    the lanes: the same metrics, the same deterministic values."""
    cell = tiny.cell("h2o-danube-3-4b")
    seed = 2 ** 31 + 11
    plain = run.execute(cell, seed, 0.0, True, "cpu")
    orig = (program.scheduler, program.telemetry, run._traced_wave,
            tr.summarize)
    res = lanes.execute(cell, seed, 0.0, "cpu")
    assert (program.scheduler, program.telemetry, run._traced_wave,
            tr.summarize) == orig
    assert res["correct"], tiny.dump(res)
    got = set(res["metrics"])
    assert got == set(plain["metrics"]) | {"chunk_fill_share"}
    assert not got & set(DEVICE)
    assert 0 < res["metrics"]["chunk_fill_share"]["value"] <= 100
    for name in ("offload_share", "prefill_saved_share"):
        assert res["metrics"][name] == plain["metrics"][name]
    assert res["window"]["ticks"] == plain["window"]["ticks"]
    assert res["breakdown"]["idle_gaps"]
    lane = res["lanes"]
    fill = lane["chunk_fill"]
    assert set(fill["tiers"]) == {"S", "L"}
    assert fill["tokens"] == sum(f["tokens"] for f in fill["tiers"].values())
    assert 0 < fill["tiers"]["L"]["tokens"] <= fill["tiers"]["L"]["positions"]
    assert lane["ticks"] > 0 and lane["device_ops"] == 0
    assert {"S.live", "L.live", "S.chunk"} <= set(lane["rows"])
    assert 0 < lane["lane_host_s"] <= lane["dispatch_host_s"]
    win = lane["window"]
    assert 0 < win["lane_s"] <= win["dispatch_s"]
