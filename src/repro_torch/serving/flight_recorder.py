"""Flight recorder: a bounded ring of per-tick scheduler snapshots, dumped
as deterministic postmortem JSON when something goes wrong.

The port's copy of the reference's ``serving/flight_recorder.py``.  The
ring keeps the last ``capacity`` snapshots and freezes them when a trigger
fires: the breaker opened, the SLO watchdog tripped, ``check_invariants``
raised (``validate=True``), or the idle-tick stall bound tripped.  A
snapshot holds the tick index, the typed counters without the wall-clock
``serve_time``, the gauges and the audit aggregates: functions of the
request trace and the seeded fault schedule only, so a dump is byte-equal
across runs (``include_timings=True`` adds wall-clock phase times and
gives that up).  ``path`` writes the most recent dump as sorted-keys JSON.
"""
from __future__ import annotations

import json
from collections import deque
from typing import Any, Dict, List, Optional


class FlightRecorder:
    """Bounded tick-snapshot ring + postmortem dump trigger."""

    def __init__(self, capacity: int = 64, path: Optional[str] = None,
                 include_timings: bool = False):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.ring: deque = deque(maxlen=self.capacity)
        self.dumps: List[Dict[str, Any]] = []
        self.path = path
        self.include_timings = bool(include_timings)

    def record(self, snapshot: Dict[str, Any]) -> None:
        """Append one per-tick snapshot (the scheduler calls this once per
        tick; the ring drops the oldest snapshot past ``capacity``)."""
        self.ring.append(snapshot)

    def trigger(self, reason: str, tick: int,
                detail: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Freeze the ring into a postmortem dump.  Returns the dump dict
        (also appended to :attr:`dumps`; written to :attr:`path` when
        configured — last trigger wins the file)."""
        dump = {
            "reason": reason,
            "tick": int(tick),
            "seq": len(self.dumps),
            "detail": dict(detail) if detail else {},
            "ring": [dict(s) for s in self.ring],
        }
        self.dumps.append(dump)
        if self.path:
            with open(self.path, "w") as f:
                f.write(self.dump_json(dump))
        return dump

    @property
    def last_dump(self) -> Optional[Dict[str, Any]]:
        return self.dumps[-1] if self.dumps else None

    @staticmethod
    def dump_json(dump: Dict[str, Any]) -> str:
        """Canonical serialization: sorted keys, fixed separators — two
        dumps with equal content serialize byte-identically."""
        return json.dumps(dump, sort_keys=True, indent=1,
                          separators=(",", ": "), default=float) + "\n"
