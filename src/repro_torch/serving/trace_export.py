"""Chrome ``trace_event`` JSON export for serving telemetry.

The port's copy of the reference's ``serving/trace_export.py``: renders a
:class:`repro_torch.serving.telemetry.Telemetry` collector for Perfetto
(https://ui.perfetto.dev) and ``chrome://tracing``.

* pid 0, the scheduler: one ``X`` event per tick-phase segment, ``C``
  (counter) events for the per-tick gauges (audit aggregates included),
  and ``i`` markers for watchdog breaches (``cat: "slo"``); the lane spans
  inside ``dispatch`` on a thread of their own (``<tier>.<lane>``,
  ``cat: "lane"``, with their tick), when the ticks recorded any;
* pid 1 (S tier) and pid 2 (L tier): one thread per slot with its request
  spans; ``queued`` and ``escalate_attempt[k]`` on queue / transport
  tracks; a ``prefill_chunk[i]`` or ``decode_block[j]`` carries the
  ``tick`` and ``lane`` that ran it, which name its lane span;
* each escalation as a flow (``s`` at the S-side attempt, ``f`` at the
  L-side ``l_verify``, ``id`` = request id); terminal statuses as
  ``terminal:<status>`` instant markers.

Timestamps are microseconds from the collector's earliest event.
"""
from __future__ import annotations

import json
import math
from typing import Any, Dict, List

# transport/queue pseudo-slots get a tid far above any real slot index
_QUEUE_TID = 1000
# the scheduler's lane-span thread, beside its tick phases (tid 0)
_LANE_TID = 1
_TIER_PID = {"S": 1, "L": 2, "": 0}


def _epoch(tel) -> float:
    t0 = math.inf
    for tick in tel.ticks:
        t0 = min(t0, tick.t0)
    for tr in tel.traces.values():
        for s in tr.spans:
            t0 = min(t0, s.t0)
    for t, _name, _args in getattr(tel, "events", ()):
        t0 = min(t0, t)
    return 0.0 if math.isinf(t0) else t0


def chrome_trace(tel) -> Dict[str, Any]:
    """Render a Telemetry collector as a Chrome trace_event dict."""
    epoch = _epoch(tel)

    def us(t: float) -> float:
        return round((t - epoch) * 1e6, 3)

    ev: List[Dict[str, Any]] = []

    def meta(pid: int, tid: int | None, key: str, name: str) -> None:
        e = {"ph": "M", "pid": pid, "name": key, "args": {"name": name}}
        if tid is not None:
            e["tid"] = tid
        ev.append(e)

    meta(0, None, "process_name", "scheduler")
    meta(0, 0, "thread_name", "tick phases")
    meta(1, None, "process_name", "S tier")
    meta(2, None, "process_name", "L tier")
    meta(1, _QUEUE_TID, "thread_name", "admission queue")
    meta(1, _QUEUE_TID + 1, "thread_name", "escalation transport")
    seen_tids = set()

    # -- scheduler ticks: phase slices + gauge counters ---------------------
    for tick in tel.ticks:
        for phase, t0, t1 in tick.segments:
            ev.append({"ph": "X", "pid": 0, "tid": 0, "name": phase,
                       "cat": "tick", "ts": us(t0),
                       "dur": max(round((t1 - t0) * 1e6, 3), 0.001),
                       "args": {"tick": tick.index}})
        for k, v in tick.gauges.items():
            ev.append({"ph": "C", "pid": 0, "name": k, "ts": us(tick.t0),
                       "args": {"value": v}})

    # -- lane spans inside dispatch -----------------------------------------
    lanes = [sp for tick in tel.ticks for sp in getattr(tick, "lanes", ())]
    if lanes:
        meta(0, _LANE_TID, "thread_name", "lanes")
    for sp in lanes:
        ev.append({"ph": "X", "pid": 0, "tid": _LANE_TID,
                   "name": f"{sp.tier}.{sp.lane}", "cat": "lane",
                   "ts": us(sp.t0),
                   "dur": max(round((sp.t1 - sp.t0) * 1e6, 3), 0.001),
                   "args": {"tick": sp.tick}})

    # -- watchdog / audit instant events ------------------------------------
    for t, name, args in getattr(tel, "events", ()):
        ev.append({"ph": "i", "pid": 0, "tid": 0, "s": "g", "name": name,
                   "cat": "slo", "ts": us(t), "args": dict(args)})

    # -- request spans ------------------------------------------------------
    for rid in sorted(tel.traces):
        tr = tel.traces[rid]
        for s in tr.spans:
            pid = _TIER_PID.get(s.tier, 0)
            if s.kind == "queued":
                tid = _QUEUE_TID
            elif s.kind in ("escalate_attempt", "escalate_backoff"):
                tid = _QUEUE_TID + 1
            else:
                tid = s.slot if s.slot >= 0 else _QUEUE_TID
            if (pid, tid) not in seen_tids and tid < _QUEUE_TID:
                seen_tids.add((pid, tid))
                meta(pid, tid, "thread_name", f"slot {tid}")
            t1 = s.t0 if not math.isfinite(s.t1) else s.t1
            args = {"request_id": rid, **s.args}
            if s.kind == "terminal":
                ev.append({"ph": "i", "pid": pid, "tid": tid, "s": "t",
                           "name": f"terminal:{s.args.get('status', '?')}",
                           "cat": "request", "ts": us(s.t0), "args": args})
                continue
            name = s.kind
            for idx_key in ("i", "j", "k"):
                if idx_key in s.args:
                    name = f"{s.kind}[{s.args[idx_key]}]"
                    break
            ev.append({"ph": "X", "pid": pid, "tid": tid, "name": name,
                       "cat": "request", "ts": us(s.t0),
                       "dur": max(round((t1 - s.t0) * 1e6, 3), 0.001),
                       "args": args})
            if s.kind == "escalate_attempt":
                ev.append({"ph": "s", "pid": pid, "tid": tid,
                           "name": "escalate", "cat": "flow",
                           "id": rid, "ts": us(s.t0)})
            elif s.kind == "l_verify":
                ev.append({"ph": "f", "pid": pid, "tid": tid, "bp": "e",
                           "name": "escalate", "cat": "flow",
                           "id": rid, "ts": us(s.t0)})

    return {"traceEvents": ev, "displayTimeUnit": "ms",
            "otherData": {"exporter": "repro_torch.serving.trace_export"}}


def write_chrome_trace(tel, path: str) -> Dict[str, Any]:
    """Serialize :func:`chrome_trace` to ``path``; returns the dict."""
    doc = chrome_trace(tel)
    with open(path, "w") as f:
        json.dump(doc, f)
    return doc
