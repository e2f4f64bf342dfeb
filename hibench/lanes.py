#!/usr/bin/env python3
"""Per-lane reduction of the traced wave: which tier and lane of the
scheduler's tick the host spends its time in, what it launches there, and
what the device does meanwhile.

While its telemetry is on, the program opens ``torch.profiler``
``record_function`` ranges (``serving/telemetry.py``): ``hi.tick``,
``hi.dispatch`` and one ``hi.<tier>.<lane>`` for each lane of a tier's
tick that runs.  They are kineto CPU ranges on the device trace's own
clock.  A device operation belongs to the lane whose range holds the CUDA
runtime call that launched it (the same correlation id); outside every
lane range, to the tick phase the host was in (telemetry's host-clock
segments, shifted by ``trace.Clock`` as ``trace.summarize`` shifts them).
Each idle gap of the device goes to the lane, or phase, the host was in
meanwhile.  The scheduler's runtimes count their chunk lanes' fill
(``chunk_tokens`` over ``chunk_positions``).

``reduce`` and ``fill_between`` are what ``run.py`` would pass to the
per-layer metrics ``chunk_fill_share``, ``kernels_per_tick``,
``dispatch_runtime_ms``, ``l_chunk_device_ms`` and ``decode_idle_share``
(``ctx.lanes``, ``ctx.chunk_fill``).  Until it does,

    python3 hibench/lanes.py --workload <cell> --seed <n> --seconds <s>

runs ``run.py``'s ``--trace 1`` path unchanged, with both read beside it:
it prints the per-lane table to standard error and, as its last line of
standard output, ``run.py``'s result object with the five metrics added to
``metrics`` and the reduction under ``lanes``.
"""
from __future__ import annotations

import time

T0 = time.monotonic()

import argparse  # noqa: E402
import bisect  # noqa: E402
import json  # noqa: E402
import re  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402
from typing import Dict, List, Sequence, Tuple  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent
# run as a script, this folder leads sys.path: its module names (trace,
# ...) must not shadow the standard library's
if sys.path and Path(sys.path[0]).resolve() == BENCH:
    sys.path.pop(0)

# the metrics this module feeds, and their units
METRICS = {"chunk_fill_share": "%", "kernels_per_tick": "count",
           "dispatch_runtime_ms": "ms", "l_chunk_device_ms": "ms",
           "decode_idle_share": "%"}
# a CUDA runtime or driver call on the host: cudaLaunchKernel,
# cuLaunchKernel, cudaMemcpyAsync, cudaStreamSynchronize, cudaMalloc, ...
RUNTIME = re.compile(r"^cu(da)?[A-Z]")
# a runtime call this long waits: on a full launch queue, a sync or the
# allocator (a launch under the profiler takes some microseconds)
SLOW_NS = 100_000
UNATTRIBUTED = "unattributed"
OUTSIDE = "outside_ticks"

Labelled = Tuple[str, float, float]


def overlay(base: Sequence[Labelled], top: Sequence[Labelled]
            ) -> List[Labelled]:
    """One timeline of disjoint labelled intervals: ``top``'s (disjoint)
    intervals, and what ``base``'s (disjoint) intervals leave outside
    them."""
    tops = sorted(top, key=lambda s: s[1])
    out = list(tops)
    j = 0
    for name, a, b in sorted(base, key=lambda s: s[1]):
        while j < len(tops) and tops[j][2] <= a:
            j += 1
        at, k = a, j
        while k < len(tops) and tops[k][1] < b:
            if tops[k][1] > at:
                out.append((name, at, tops[k][1]))
            at = max(at, tops[k][2])
            k += 1
        if at < b:
            out.append((name, at, b))
    return sorted(out, key=lambda s: s[1])


def _inside(intervals: Sequence[Tuple[float, float]], starts: List[float],
            t: float) -> int:
    """The index of the disjoint sorted interval holding ``t``, or -1."""
    i = bisect.bisect_right(starts, t) - 1
    return i if i >= 0 and t < intervals[i][1] else -1


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def reduce(events, window_name: str, clock,
           segments: Sequence[Labelled] = ()) -> dict:
    """``events``: the profiler's kineto events; ``window_name``: the range
    that bounds the traced window; ``clock``: the ``trace.Clock`` entered
    under the profiler; ``segments``: telemetry's (phase, start, end) in
    ``time.monotonic`` seconds.  Returns the wave's ``ticks`` (``hi.tick``
    ranges), ``window_s``, ``device_ops``, ``busy_s`` and the share of it
    put to a lane or phase (``attributed_share``), the host seconds in
    lane and ``hi.dispatch`` ranges, the kernels, runtime seconds and
    device seconds launched under ``hi.dispatch`` (``dispatch``),
    ``rows``: per lane (``<tier>.<lane>``) or phase, the totals ``host_s``,
    ``device_s``, ``kernels``, ``runtime_s`` and ``idle_s``, and ``calls``:
    per lane or phase and runtime call name, [calls, seconds, seconds in
    calls of ``SLOW_NS`` or more]."""
    from hibench import trace as tr
    win = [e for e in events if e.name() == window_name]
    if not win:
        raise RuntimeError(f"the trace holds no {window_name!r} range")
    lo, hi = win[0].start_ns(), win[0].end_ns()
    ranges = defaultdict(list)             # hi.* name -> [(start, end)]
    runtime, device = [], []
    for e in events:
        a, b, name = e.start_ns(), e.end_ns(), e.name()
        if b <= lo or a >= hi:
            continue
        on_host = e.device_type().name == "CPU"
        if e.is_user_annotation():
            if on_host and name.startswith("hi."):
                ranges[name].append((a, b))
        elif on_host:
            if RUNTIME.match(name):
                runtime.append((a, b, e.correlation_id(), name))
        elif b > a:
            device.append((max(a, lo), min(b, hi), name, e.correlation_id()))
    lanes = sorted(((name[3:], a, b) for name, spans in ranges.items()
                    if name.count(".") == 2 for a, b in spans),
                   key=lambda s: s[1])
    dispatch = sorted(ranges.get("hi.dispatch", []))
    d_starts = [a for a, _ in dispatch]
    off = clock.offset_ns(events)
    phases = [(n, s0 * 1e9 + off, s1 * 1e9 + off) for n, s0, s1 in segments]
    timeline = overlay(phases, lanes)
    t_iv = [(a, b) for _, a, b in timeline]
    t_starts = [a for a, _ in t_iv]

    def label(t):
        i = _inside(t_iv, t_starts, t)
        return timeline[i][0] if i >= 0 else OUTSIDE

    rows = defaultdict(lambda: dict.fromkeys(
        ("host_s", "device_s", "kernels", "runtime_s", "idle_s"), 0))
    for name, a, b in timeline:
        a, b = max(a, lo), min(b, hi)
        if b > a:
            rows[name]["host_s"] += (b - a) / 1e9
    under = {"kernels": 0, "runtime_s": 0.0, "device_s": 0.0}
    calls = defaultdict(lambda: defaultdict(lambda: [0, 0.0, 0.0]))
    launch = {}                        # correlation id -> (label, dispatch)
    for a, b, corr, name in runtime:
        where = label(a)
        in_dispatch = _inside(dispatch, d_starts, a) >= 0
        rows[where]["runtime_s"] += (b - a) / 1e9
        call = calls[where][name]
        call[0] += 1
        call[1] += (b - a) / 1e9
        call[2] += (b - a) / 1e9 if b - a >= SLOW_NS else 0.0
        if in_dispatch:
            under["runtime_s"] += (b - a) / 1e9
        launch[corr] = (where, in_dispatch)
    attributed = []
    for a, b, name, corr in device:
        where, in_dispatch = launch.get(corr, (UNATTRIBUTED, False))
        row = rows[where]
        row["device_s"] += (b - a) / 1e9
        if not _is_copy(name):
            row["kernels"] += 1
        if in_dispatch:
            under["device_s"] += (b - a) / 1e9
            under["kernels"] += not _is_copy(name)
        if where != UNATTRIBUTED:
            attributed.append((a, b))
    busy = tr.union([(a, b) for a, b, _, _ in device])
    for name, t in tr.attribute(tr.gaps(busy, lo, hi), timeline,
                                OUTSIDE).items():
        rows[name]["idle_s"] += t / 1e9
    busy_ns = sum(b - a for a, b in busy)
    return {
        "ticks": len(ranges.get("hi.tick", [])),
        "window_s": (hi - lo) / 1e9,
        "device_ops": len(device),
        "busy_s": busy_ns / 1e9,
        "attributed_share": (sum(b - a for a, b in tr.union(attributed))
                             / busy_ns if busy_ns else None),
        "lane_host_s": sum(min(b, hi) - max(a, lo)
                           for _, a, b in lanes) / 1e9,
        "dispatch_host_s": sum(min(b, hi) - max(a, lo)
                               for a, b in dispatch) / 1e9,
        "dispatch": under,
        "rows": {k: dict(v) for k, v in sorted(rows.items())},
        "calls": {k: dict(sorted(v.items())) for k, v in sorted(calls.items())},
    }


def chunk_fill(sched) -> Dict[str, Tuple[int, int]]:
    """Each tier's chunk-lane counters: (real prompt tokens fed, W x C
    positions computed)."""
    return {rt.name: (rt.chunk_tokens, rt.chunk_positions)
            for rt in (*sched.srts, sched.lrt)}


def fill_between(before: dict, after: dict) -> dict:
    """The chunk lanes' fill between two ``chunk_fill`` readings: both
    tiers' ``tokens`` and ``positions``, and each tier's under ``tiers``."""
    tiers = {k: {"tokens": t - before[k][0], "positions": n - before[k][1]}
             for k, (t, n) in after.items()}
    return {"tokens": sum(v["tokens"] for v in tiers.values()),
            "positions": sum(v["positions"] for v in tiers.values()),
            "tiers": tiers}


def table(lanes: dict) -> str:
    """The per-lane table, one row per tier x lane and per phase, in
    milliseconds (and kernels) per tick of the traced wave."""
    n = max(lanes["ticks"], 1)
    head = (f"{'lane':<16}{'host ms':>10}{'device ms':>11}{'kernels':>10}"
            f"{'runtime ms':>12}{'idle ms':>10}")
    lines = [f"lanes: {lanes['ticks']} ticks, window "
             f"{lanes['window_s']:.3f} s, busy {lanes['busy_s']:.3f} s",
             head]
    for name, r in sorted(lanes["rows"].items(),
                          key=lambda kv: ("." not in kv[0], kv[0])):
        lines.append(f"{name:<16}{1e3 * r['host_s'] / n:>10.3f}"
                     f"{1e3 * r['device_s'] / n:>11.3f}"
                     f"{r['kernels'] / n:>10.1f}"
                     f"{1e3 * r['runtime_s'] / n:>12.3f}"
                     f"{1e3 * r['idle_s'] / n:>10.3f}")
    return "\n".join(lines)


def execute(cell, seed: int, seconds: float, device: str,
            t0: float = None) -> dict:
    """``run.execute`` with ``--trace 1``, unchanged, and the lanes read
    beside it: the chunk counters across the window (from its start, where
    ``run.execute`` takes the scheduler, to the traced wave), the
    reduction of the traced wave's events, and the window's telemetry
    (``window``: its lane spans' and ``dispatch`` phase's host seconds)."""
    from hibench import program, run
    from hibench import trace as tr
    got = {"tel": []}
    orig = (program.scheduler, program.telemetry, run._traced_wave,
            tr.summarize)
    scheduler, telemetry, traced_wave, summarize = orig

    def at_window_start(engine):
        sched = scheduler(engine)
        got["fill0"] = chunk_fill(sched)
        return sched

    def new_telemetry():
        got["tel"].append(telemetry())
        return got["tel"][-1]

    def after_window(engine, *args):
        got["fill"] = fill_between(got["fill0"], chunk_fill(scheduler(engine)))
        return traced_wave(engine, *args)

    def summary(events, window_name, clock, segments=(), top_n=10):
        events = list(events)
        got["lanes"] = reduce(events, window_name, clock, segments)
        return summarize(events, window_name, clock, segments, top_n)

    (program.scheduler, program.telemetry, run._traced_wave,
     tr.summarize) = (at_window_start, new_telemetry, after_window, summary)
    try:
        result = run.execute(cell, seed, seconds, True, device, t0)
    finally:
        (program.scheduler, program.telemetry, run._traced_wave,
         tr.summarize) = orig
    lanes = got.get("lanes")
    if lanes is not None and got["tel"]:
        tel = got["tel"][0]
        lanes["window"] = {"lane_s": sum(tel.lane_time.values()),
                           "dispatch_s": tel.phase_time.get("dispatch", 0.0),
                           "lane_time": dict(sorted(tel.lane_time.items()))}
    ctx = SimpleNamespace(lanes=lanes, chunk_fill=got.get("fill"))
    for name, unit in METRICS.items():
        v = run.read_metric(BENCH / "metrics" / f"{name}.py", ctx)
        if v is not None:
            result["metrics"][name] = {"value": float(v), "unit": unit}
    result["lanes"] = dict(lanes or {}, chunk_fill=got.get("fill"))
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from hibench import run
    run._env()
    cell = run.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"hibench: cell {cell.name} needs {cell.chips} CUDA device(s)",
              file=sys.stderr)
        return 3
    result = execute(cell, args.seed, args.seconds, "cuda", T0)
    result["device"]["power"] = run.power_limit()
    lanes = result["lanes"]
    if lanes.get("rows") is not None:
        print(table(lanes), file=sys.stderr)
    for tier, f in (lanes["chunk_fill"] or {}).get("tiers", {}).items():
        print(f"chunk fill {tier}: {f['tokens']} of {f['positions']}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
