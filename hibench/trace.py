"""Reduction of a ``torch.profiler`` trace to the device's busy time, its
busiest operations and its idle gaps.

Busy time is the union of the device's kernel, memcpy and memset
intervals inside the traced window: overlapping activities count once.
Each idle gap is put to what the host was doing then, read from the
scheduler's tick phases (``serving/telemetry.py``'s host-clock segments),
shifted onto the profiler's clock by a marker taken at a known time.
"""
from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

Interval = Tuple[float, float]


def union(intervals: Sequence[Interval]) -> List[Interval]:
    """The union of intervals, as sorted disjoint intervals."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def clip(intervals: Sequence[Interval], lo: float, hi: float) -> List[Interval]:
    return [(max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi]


def gaps(busy: Sequence[Interval], lo: float, hi: float) -> List[Interval]:
    """The complement of disjoint sorted ``busy`` inside [lo, hi]."""
    out, at = [], lo
    for a, b in busy:
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if at < hi:
        out.append((at, hi))
    return out


def attribute(gap_list: Sequence[Interval],
              segments: Sequence[Tuple[str, float, float]],
              other: str = "outside_ticks") -> Dict[str, float]:
    """Total gap time per segment label; time under no segment goes to
    ``other``.  Segments must not overlap."""
    segs = sorted(segments, key=lambda s: s[1])
    total: Dict[str, float] = defaultdict(float)
    j = 0
    for a, b in gap_list:
        covered = 0.0
        while j < len(segs) and segs[j][2] <= a:
            j += 1
        k = j
        while k < len(segs) and segs[k][1] < b:
            name, s0, s1 = segs[k]
            part = min(b, s1) - max(a, s0)
            if part > 0:
                total[name] += part
                covered += part
            k += 1
        if b - a - covered > 0:
            total[other] += b - a - covered
    return dict(total)


def top(table: Dict[str, float], n: int = 10) -> List[list]:
    return [[k, v] for k, v in sorted(table.items(), key=lambda kv: -kv[1])[:n]]


class Clock:
    """Maps ``time.monotonic()`` readings onto the profiler's clock: enter
    ``marker()`` under the profiler, then ``offset_ns(events)``."""

    NAME = "hibench.clock"

    def __init__(self):
        self.mono_ns = 0

    def marker(self):
        from torch.profiler import record_function
        self.mono_ns = time.monotonic_ns()
        return record_function(self.NAME)

    def offset_ns(self, events) -> int:
        for e in events:
            if e.name() == self.NAME:
                return e.start_ns() - self.mono_ns
        raise RuntimeError("the trace holds no clock marker")


def summarize(events, window_name: str, clock: Clock,
              segments: Sequence[Tuple[str, float, float]] = (),
              top_n: int = 10) -> dict:
    """``events``: the profiler's kineto events.  ``window_name``: the
    ``record_function`` range that bounds the traced window.
    ``segments``: (label, start, end) in ``time.monotonic`` seconds.
    Returns busy_s, window_s, device_ops, idle_gaps and the device time
    per operation name (``op_s``)."""
    win = [e for e in events if e.name() == window_name]
    if not win:
        raise RuntimeError(f"the trace holds no {window_name!r} range")
    lo, hi = win[0].start_ns(), win[0].end_ns()
    dev = [(e.start_ns(), e.end_ns(), e.name()) for e in events
           if e.device_type().name == "CUDA" and e.end_ns() > e.start_ns()
           and not e.is_user_annotation()]
    busy = union(clip([(a, b) for a, b, _ in dev], lo, hi))
    op_s: Dict[str, float] = defaultdict(float)
    for a, b, name in dev:
        if b > lo and a < hi:
            op_s[name] += (min(b, hi) - max(a, lo)) / 1e9
    off = clock.offset_ns(events)
    segs = [(n, s0 * 1e9 + off, s1 * 1e9 + off) for n, s0, s1 in segments]
    idle = attribute(gaps(busy, lo, hi), segs)
    short: Dict[str, float] = defaultdict(float)
    for k, v in op_s.items():
        short[k[:160]] += v
    return {"busy_s": sum(b - a for a, b in busy) / 1e9,
            "window_s": (hi - lo) / 1e9,
            "device_ops": top(short, top_n),
            "idle_gaps": top({k: v / 1e9 for k, v in idle.items()}, top_n),
            "op_s": dict(op_s)}


def tick_segments(tel) -> List[Tuple[str, float, float]]:
    """(phase, start, end) of every tick the telemetry recorded."""
    return [seg for tick in tel.ticks for seg in tick.segments]
