"""Scheduler counters: the typed store and its dict view.

The port's minimal copy of the reference's ``serving/telemetry.py``:
:class:`SchedCounters` and :class:`StatsView` only.  The collectors
(``Telemetry``, ``GateAudit``, ``SLOWatchdog``, ``FlightRecorder``) are not
ported yet (ROADMAP Queue A item 7); ``serve_stream`` raises when one is
passed.
"""
from __future__ import annotations

from collections.abc import MutableMapping
from dataclasses import dataclass, fields
from typing import Any


@dataclass
class SchedCounters:
    """The ContinuousScheduler's typed counters (one instance per scheduler;
    ``scheduler.stats`` is a :class:`StatsView` over it)."""
    requests: int = 0
    offloaded: int = 0
    dropped: int = 0
    ticks: int = 0
    compiles: int = 0
    serve_time: float = 0.0
    blocks: int = 0
    escalated_blocks: int = 0
    drafted: int = 0
    accepted: int = 0
    degraded_local: int = 0
    rejected: int = 0
    breaker_open_ticks: int = 0
    breaker_opens: int = 0
    esc_retries: int = 0
    esc_lost: int = 0


class StatsView(MutableMapping):
    """Dict-API view over a counters dataclass: ``view["ticks"] += 1``
    mutates ``counters.ticks``.  Unknown keys raise KeyError (typos that a
    plain dict would silently absorb)."""

    def __init__(self, counters: Any):
        self._c = counters
        self._keys = tuple(f.name for f in fields(counters))

    def __getitem__(self, k):
        if k not in self._keys:
            raise KeyError(k)
        return getattr(self._c, k)

    def __setitem__(self, k, v):
        if k not in self._keys:
            raise KeyError(k)
        setattr(self._c, k, v)

    def __delitem__(self, k):
        raise TypeError("typed counters cannot be deleted")

    def __iter__(self):
        return iter(self._keys)

    def __len__(self):
        return len(self._keys)

    def __repr__(self):
        return f"StatsView({dict(self)})"
