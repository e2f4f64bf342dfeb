"""Serving telemetry: typed counters, per-request span trees, tick-phase
timing, pool gauges and streaming histograms, at no cost when disabled.

The port's copy of the reference's ``serving/telemetry.py``.  Everything
here is host-side bookkeeping over state the scheduler already holds:
enabling telemetry adds no device work, no host sync and no operand, so a
tick keeps its one ``_host_fetch`` and ``stream_compiles`` does not move;
disabled (the default) each scheduler hook is one ``is None`` test.

* **Typed counters** (:class:`SchedCounters`, :class:`EngineCounters`) and
  their dict views (:class:`StatsView`, :class:`EngineStatsView`): the
  engine reads the live scheduler's counters through the view, so the two
  stores cannot diverge.
* **Per-request span trees** (:class:`Telemetry`, :class:`Span`,
  :class:`RequestTrace`)::

      queued -> admitted -> prefill_chunk[i] -> decode_block[j]
             -> escalate_attempt[k] -> l_verify -> terminal

  with the terminal status, TTFT, TPOT, queue-wait ticks and retries.
  Span times are ``time.monotonic()`` seconds; device work inside a tick
  is attributed to the tick's wall bracket.
* **Tick-phase timing and gauges** (:class:`TickRecord`): ``fault_tick``
  (breaker, transport and drop bookkeeping plus admission),
  ``build_operands`` (numpy operands and the one host->device copy),
  ``dispatch`` (the lanes' kernel launches; on the card the launches are
  asynchronous, so this is launch time), ``host_fetch`` (the tick's one
  device->host copy, which absorbs the device time) and ``postprocess``;
  plus the pool, breaker and queue gauges sampled once a tick.
* **Lane spans** (:class:`LaneSpan`): inside ``dispatch``, one span per
  lane that each tier's tick runs (``cow``, ``admit``, ``chunk``, ``live``,
  ``verify``), in :attr:`TickRecord.lanes`, with the host seconds per
  ``<tier>.<lane>`` in :attr:`Telemetry.lane_time`.  The tick, its
  ``dispatch`` bracket and each lane also open a
  ``torch.profiler.record_function`` range (``hi.tick``, ``hi.dispatch``,
  ``hi.<tier>.<lane>``): under a profiler these are kineto CPU ranges on
  the device trace's own clock, so a kernel's launching call (by
  correlation id) and each idle gap of the device fall under the lane the
  host was in.  Off, no range is opened.

Exporters: :meth:`Telemetry.histogram_summary` (log-bucketed TTFT / TPOT /
queue-wait / escalation-latency histograms with p50/p95/p99),
:meth:`Telemetry.prometheus_text` (a Prometheus text snapshot: ``# HELP`` /
``# TYPE`` per family, escaped label values, ``hi_<counter>_total``,
``hi_tick_phase_seconds_total{phase=...}``, ``hi_gauge{name=...,tier=...}``,
the histograms with the overflow bucket folded into ``+Inf``, and the
``hi_audit_*`` families when a ``GateAudit`` is bound), and
``serving/trace_export.py`` (Chrome trace JSON).
"""
from __future__ import annotations

import math
import time
from collections.abc import MutableMapping
from dataclasses import dataclass, field, fields
from typing import Any, Dict, List, Optional, Tuple

from torch.profiler import record_function

# Tick-phase wall-time buckets, in the reference's intra-tick order.
# ``transfer_overlap`` is the mesh tick's escalation staging (the staging
# write and the L admit lane's gather, ``scheduler._dispatch``), which
# the port marks just after ``build_operands``: both ride in the tick's one
# upload.  The single-device tick never marks it.
PHASES = ("fault_tick", "transfer_overlap", "build_operands", "dispatch",
          "host_fetch", "postprocess")

_now = time.monotonic

# one-line HELP strings for the prometheus_text metric families
_HELP = {
    "hi_tick_phase_seconds_total":
        "Cumulative wall seconds per scheduler tick phase.",
    "hi_gauge":
        "Last-sampled per-tick pool/breaker/queue gauge (tier-labelled).",
    "ttft": "Time to first token.",
    "tpot": "Time per output token (after the first).",
    "queue_wait": "Escalation queue wait.",
    "esc_latency": "Escalation send-to-terminal latency.",
}


def escape_label(value: str) -> str:
    """Escape a Prometheus label VALUE per the text exposition format
    (backslash, double quote, newline)."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


# ---------------------------------------------------------------------------
# typed counters + dict views
# ---------------------------------------------------------------------------

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


@dataclass
class EngineCounters:
    """HIEngine's own counter store.  For the keys the scheduler also
    counts, this holds the RETIRED base (drain-path contributions plus the
    folded totals of replaced schedulers); :class:`EngineStatsView` adds the
    live scheduler's counters on read.  ``cache_allocs`` counts the drain
    path's cache allocations (the reference counts its compiles)."""
    requests: int = 0
    offloaded: int = 0
    dropped: int = 0
    serve_time: float = 0.0
    cache_allocs: int = 0
    stream_compiles: int = 0
    stream_ticks: int = 0
    prefill_tokens_saved: int = 0
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


# engine key -> scheduler counter attribute it mirrors live
_MIRROR = {
    "requests": "requests", "offloaded": "offloaded", "dropped": "dropped",
    "serve_time": "serve_time", "stream_ticks": "ticks",
    "degraded_local": "degraded_local", "rejected": "rejected",
    "breaker_open_ticks": "breaker_open_ticks",
    "breaker_opens": "breaker_opens", "esc_retries": "esc_retries",
    "esc_lost": "esc_lost",
}


class EngineStatsView(StatsView):
    """Engine stats = retired base + the LIVE scheduler's typed counters.

    The engine used to copy the scheduler's fault counters key by key after
    every ``serve_stream`` and zero the originals — two stores that could
    silently diverge.  Now there is one authority: the scheduler's
    :class:`SchedCounters`.  Reads of a mirrored key add the attached
    scheduler's live value; writes adjust the base so the observed total
    becomes the written value (``stats[k] += x`` adds exactly ``x``
    regardless of live activity).  ``prefill_tokens_saved`` mirrors the
    pools' prefix stats the same way.  When the engine replaces its cached
    scheduler, :meth:`detach` folds the live totals into the base so
    nothing is lost."""

    def __init__(self, counters: EngineCounters):
        super().__init__(counters)
        self._sched = None

    def attach(self, sched) -> None:
        if self._sched is not None and self._sched is not sched:
            self.detach()
        self._sched = sched

    def detach(self) -> None:
        """Fold the attached scheduler's live counters into the base."""
        if self._sched is None:
            return
        sched, self._sched = self._sched, None
        for k in tuple(_MIRROR) + ("prefill_tokens_saved",):
            setattr(self._c, k, getattr(self._c, k) + self._live(sched, k))

    @staticmethod
    def _live(sched, k):
        if k == "prefill_tokens_saved":
            return sched.prefix_stats.get("tokens_saved", 0)
        return getattr(sched.counters, _MIRROR[k])

    def __getitem__(self, k):
        v = super().__getitem__(k)
        if self._sched is not None and (k in _MIRROR
                                        or k == "prefill_tokens_saved"):
            v = v + self._live(self._sched, k)
        return v

    def __setitem__(self, k, v):
        if self._sched is not None and (k in _MIRROR
                                        or k == "prefill_tokens_saved"):
            v = v - self._live(self._sched, k)
        super().__setitem__(k, v)


# ---------------------------------------------------------------------------
# streaming histograms
# ---------------------------------------------------------------------------

class Histogram:
    """Streaming log-bucketed histogram: base-2 buckets over [lo, hi).

    Bucket 0 is the underflow (< lo), the last bucket the overflow; bucket
    ``i`` covers ``[lo * 2^(i-1), lo * 2^i)``.  Constant memory, O(1)
    record, quantiles by cumulative-count walk (geometric-midpoint estimate
    within the landing bucket — exact min/max are tracked separately)."""

    def __init__(self, lo: float = 1e-4, hi: float = 100.0,
                 unit: str = "seconds"):
        if lo <= 0 or hi <= lo:
            raise ValueError(f"need 0 < lo < hi, got ({lo}, {hi})")
        self.lo = lo
        self.unit = unit
        self.n_buckets = int(math.ceil(math.log2(hi / lo))) + 2
        self.counts = [0] * self.n_buckets
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def record(self, v: float) -> None:
        if not math.isfinite(v):
            return
        if v < self.lo:
            i = 0
        else:
            i = min(self.n_buckets - 1,
                    1 + int(math.floor(math.log2(v / self.lo))))
        self.counts[i] += 1
        self.count += 1
        self.total += v
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)

    def upper_edge(self, i: int) -> float:
        return self.lo * 2.0 ** i           # bucket i covers [edge/2, edge)

    def quantile(self, q: float) -> float:
        if not self.count:
            return math.nan
        target = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= target and c:
                if i == 0:
                    return min(self.lo, self.vmax)
                hi = min(self.upper_edge(i), self.vmax)
                lo = max(self.upper_edge(i - 1), self.vmin)
                return math.sqrt(lo * hi) if lo > 0 else hi / 2
        return self.vmax

    def summary(self) -> Dict[str, float]:
        if not self.count:
            return {"count": 0}
        return {"count": self.count,
                "mean": self.total / self.count,
                "min": self.vmin, "max": self.vmax,
                "p50": self.quantile(0.50),
                "p95": self.quantile(0.95),
                "p99": self.quantile(0.99)}


# ---------------------------------------------------------------------------
# spans + traces + ticks
# ---------------------------------------------------------------------------

@dataclass
class Span:
    kind: str                   # queued / admitted / prefill_chunk / ...
    t0: float                   # monotonic seconds
    t1: float                   # t0 == t1 for instant markers
    tier: str                   # "S" / "L" / "" (scheduler-level)
    slot: int = -1
    args: Dict[str, Any] = field(default_factory=dict)


@dataclass
class RequestTrace:
    """One request's span tree (flat list, tree by construction order)."""
    rid: int
    submit_t: float = 0.0
    spans: List[Span] = field(default_factory=list)
    status: str = ""            # set at terminal
    ttft: float = math.nan
    tpot: float = math.nan
    n_tokens: int = 0
    queue_wait_ticks: int = 0
    escalation_retries: int = 0

    @property
    def complete(self) -> bool:
        return bool(self.status)


@dataclass
class LaneSpan:
    """One lane of one tier's tick, on the host clock: ``lane`` is a name
    of ``scheduler.LANES`` or ``verify``, ``tick`` the tick that ran it."""
    tier: str
    lane: str
    t0: float
    t1: float
    tick: int


@dataclass
class TickRecord:
    index: int                  # global scheduler tick number
    t0: float
    t1: float = 0.0
    # ordered (phase, start, end) wall segments within the tick
    segments: List[Tuple[str, float, float]] = field(default_factory=list)
    gauges: Dict[str, float] = field(default_factory=dict)
    # the lanes that ran, in order, inside the ``dispatch`` segment
    lanes: List[LaneSpan] = field(default_factory=list)


def _open_range(name: str) -> record_function:
    rf = record_function(name)
    rf.__enter__()
    return rf


class _Lane:
    """The context of one lane: its ``hi.<tier>.<lane>`` profiler range
    inside its host-clock span."""
    __slots__ = ("tel", "tier", "lane", "t0", "rf")

    def __init__(self, tel: "Telemetry", tier: str, lane: str):
        self.tel, self.tier, self.lane = tel, tier, lane

    def __enter__(self):
        self.t0 = _now()
        self.rf = _open_range(f"hi.{self.tier}.{self.lane}")

    def __exit__(self, *exc):
        self.rf.__exit__(*exc)
        self.tel._lane_done(self.tier, self.lane, self.t0, _now())


class Telemetry:
    """Per-run collector threaded through ContinuousScheduler / HIEngine.

    The scheduler holds ``tel = None`` by default; every hook call site is
    guarded by ``if tel is not None`` — disabled telemetry costs one branch
    per site and allocates nothing.  One Telemetry instance may span several
    ``serve_stream`` calls (counters/histograms accumulate; ticks/spans
    append)."""

    def __init__(self):
        self.traces: Dict[int, RequestTrace] = {}
        self.ticks: List[TickRecord] = []
        self.phase_time: Dict[str, float] = {p: 0.0 for p in PHASES}
        self.hists: Dict[str, Histogram] = {
            "ttft": Histogram(1e-4, 100.0),
            "tpot": Histogram(1e-5, 100.0),
            "queue_wait": Histogram(0.5, 4096.0, unit="ticks"),
            "esc_latency": Histogram(1e-4, 100.0),
        }
        self.counters: Optional[SchedCounters] = None   # bound by scheduler
        # GateAudit bound by the scheduler when both are installed — its
        # hi_audit_* families ride prometheus_text; None = no audit lines
        self.audit = None
        # (t, name, args) instant events (SLO watchdog breaches) — rendered
        # as Chrome ``i`` markers on the scheduler track by trace_export
        self.events: List[Tuple[float, str, Dict[str, Any]]] = []
        # host seconds per "<tier>.<lane>" over every tick
        self.lane_time: Dict[str, float] = {}
        self._tick: Optional[TickRecord] = None
        # the open hi.tick / hi.dispatch profiler ranges
        self._tick_range: Optional[record_function] = None
        self._dispatch_range: Optional[record_function] = None
        self._mark_t = 0.0
        # (rid, kind) -> open span awaiting its close
        self._open: Dict[Tuple[int, str], Span] = {}
        # per-(rid, kind) occurrence counters for the [i]/[j]/[k] indices
        self._seq: Dict[Tuple[int, str], int] = {}

    # -- tick lifecycle -----------------------------------------------------

    def begin_tick(self, index: int) -> None:
        self._close_ranges()             # of a tick that raised
        t = _now()
        self._tick = TickRecord(index=index, t0=t)
        self._mark_t = t
        self._tick_range = _open_range("hi.tick")

    def begin_dispatch(self) -> None:
        """Open the ``hi.dispatch`` profiler range, at the start of the
        ``dispatch`` segment; ``mark("dispatch")`` closes it."""
        self._dispatch_range = _open_range("hi.dispatch")

    def lane(self, tier: str, lane: str) -> _Lane:
        """The context of one lane of ``tier``'s tick: a :class:`LaneSpan`
        of the in-flight tick and a ``hi.<tier>.<lane>`` profiler range."""
        return _Lane(self, tier, lane)

    def _lane_done(self, tier: str, lane: str, t0: float, t1: float) -> None:
        key = f"{tier}.{lane}"
        self.lane_time[key] = self.lane_time.get(key, 0.0) + (t1 - t0)
        if self._tick is not None:
            self._tick.lanes.append(LaneSpan(tier, lane, t0, t1,
                                             self._tick.index))

    def _close_ranges(self) -> None:
        for name in ("_dispatch_range", "_tick_range"):
            rf = getattr(self, name)
            if rf is not None:
                rf.__exit__(None, None, None)
                setattr(self, name, None)

    def drop_tick(self) -> None:
        """Abandon the in-flight tick unrecorded (the scheduler found
        nothing left for the device) and close its profiler range."""
        self._close_ranges()
        self._tick = None

    def mark(self, phase: str) -> None:
        """Close the wall segment since the previous mark under ``phase``."""
        if phase == "dispatch" and self._dispatch_range is not None:
            self._dispatch_range.__exit__(None, None, None)
            self._dispatch_range = None
        t = _now()
        tick = self._tick
        if tick is not None:
            tick.segments.append((phase, self._mark_t, t))
        self.phase_time[phase] = self.phase_time.get(phase, 0.0) \
            + (t - self._mark_t)
        self._mark_t = t

    def end_tick(self, gauges: Dict[str, float]) -> None:
        tick = self._tick
        if tick is None:
            return
        self._close_ranges()
        tick.t1 = _now()
        tick.gauges = gauges
        self.ticks.append(tick)
        self._tick = None

    def instant(self, name: str, **args: Any) -> None:
        """Record a scheduler-level instant event (e.g. an SLO watchdog
        breach) — exported as a Chrome ``i`` marker on the tick track."""
        self.events.append((_now(), name, args))

    @property
    def tick_bracket(self) -> Tuple[float, float]:
        """(start, now) of the in-flight tick — device work inside the tick
        is attributed to this bracket."""
        t = _now()
        return (self._tick.t0 if self._tick is not None else t, t)

    # -- request spans ------------------------------------------------------

    def _trace(self, rid: int, submit_t: float = 0.0) -> RequestTrace:
        tr = self.traces.get(rid)
        if tr is None:
            tr = self.traces[rid] = RequestTrace(rid, submit_t=submit_t)
        return tr

    def _next_idx(self, rid: int, kind: str) -> int:
        i = self._seq.get((rid, kind), 0)
        self._seq[(rid, kind)] = i + 1
        return i

    def span_point(self, rid: int, kind: str, tier: str, slot: int,
                   **args) -> Span:
        """Closed span covering the current tick bracket."""
        t0, t1 = self.tick_bracket
        sp = Span(kind, t0, t1, tier, slot, args)
        self._trace(rid).spans.append(sp)
        return sp

    def span_open(self, rid: int, kind: str, tier: str, slot: int,
                  **args) -> Span:
        sp = Span(kind, _now(), math.nan, tier, slot, args)
        self._trace(rid).spans.append(sp)
        self._open[(rid, kind)] = sp
        return sp

    def span_close(self, rid: int, kind: str, **args) -> Optional[Span]:
        sp = self._open.pop((rid, kind), None)
        if sp is not None:
            sp.t1 = _now()
            sp.args.update(args)
        return sp

    # -- scheduler hooks ----------------------------------------------------

    def req_admitted(self, tier: str, slot: int, rid: int, submit_t: float,
                     *, chunked: bool = False, restore: bool = False,
                     start: int = 0) -> None:
        tr = self._trace(rid, submit_t)
        t0, t1 = self.tick_bracket
        # the S admission starts the queued span, the L one opens l_verify
        if tier == "S" and not any(s.kind == "queued" for s in tr.spans):
            tr.submit_t = submit_t
            tr.spans.append(Span("queued", submit_t, t0, "S"))
        tr.spans.append(Span("admitted", t0, t1, tier, slot,
                             {"chunked": chunked, "restore": restore,
                              "start": start}))
        if tier == "L":
            # L residency: admission to finish/abort
            self.span_open(rid, "l_verify", "L", slot)

    def req_chunk(self, tier: str, slot: int, rid: int, fed: int,
                  keep: int, **cause) -> None:
        """``cause``: the ``tick`` and ``lane`` that ran the chunk."""
        self.span_point(rid, "prefill_chunk", tier, slot,
                        i=self._next_idx(rid, f"{tier}:prefill_chunk"),
                        fed=fed, keep=keep, **cause)

    def req_decode(self, tier: str, slot: int, rid: int, steps: int,
                   **cause) -> None:
        """``cause``: the ``tick`` and ``lane`` that ran the block."""
        self.span_point(rid, "decode_block", tier, slot,
                        j=self._next_idx(rid, f"{tier}:decode_block"),
                        steps=steps, **cause)

    def req_esc_send(self, rid: int, slot: int, attempt: int) -> None:
        self.span_open(rid, "escalate_attempt", "S", slot, k=attempt)

    def req_esc_end(self, rid: int, outcome: str) -> None:
        """Close the in-flight escalate_attempt span: ``outcome`` is
        ``arrived`` / ``lost`` / ``timeout`` / ``aborted`` / ``gave_up``."""
        self.span_close(rid, "escalate_attempt", outcome=outcome)

    def req_esc_retry(self, rid: int, attempt: int,
                      resend_tick: int) -> None:
        self.span_point(rid, "escalate_backoff", "S", -1, k=attempt,
                        resend_tick=resend_tick)

    def req_l_verify(self, slot: int, rid: int, accepted: int,
                     emitted: int, **cause) -> None:
        """Speculative path: one escalated verify block (``cause``: the
        ``tick`` and ``lane`` that ran it)."""
        self.span_point(rid, "l_verify", "L", slot, accepted=accepted,
                        emitted=emitted, **cause)

    def req_l_release(self, rid: int, outcome: str) -> None:
        self.span_close(rid, "l_verify", outcome=outcome)

    def req_terminal(self, rid: int, record: Dict[str, Any]) -> None:
        """The request reached its FINAL status: close open spans, stamp the
        terminal marker, and feed the latency histograms."""
        tr = self._trace(rid)
        t = _now()
        self.req_esc_end(rid, "gave_up")
        self.req_l_release(rid, record.get("status", ""))
        tr.status = str(record.get("status", "ok"))
        tr.ttft = float(record.get("ttft", math.nan))
        tr.n_tokens = int(len(record.get("tokens", ())))
        tr.queue_wait_ticks = int(record.get("queue_wait_ticks", 0))
        tr.escalation_retries = int(record.get("escalation_retries", 0))
        if tr.n_tokens > 1 and math.isfinite(tr.ttft):
            first = tr.submit_t + tr.ttft
            tr.tpot = max(t - first, 0.0) / (tr.n_tokens - 1)
            self.hists["tpot"].record(tr.tpot)
        if math.isfinite(tr.ttft):
            self.hists["ttft"].record(tr.ttft)
        self.hists["queue_wait"].record(tr.queue_wait_ticks)
        esc0 = next((s for s in tr.spans
                     if s.kind == "escalate_attempt"), None)
        if esc0 is not None:
            self.hists["esc_latency"].record(t - esc0.t0)
        tr.spans.append(Span("terminal", t, t, "S", -1,
                             {"status": tr.status}))

    # -- exporters ----------------------------------------------------------

    def request_records(self) -> List[Dict[str, Any]]:
        """Structured per-request records (the span-tree face), alongside —
        never replacing — the scheduler's result records."""
        out = []
        for rid in sorted(self.traces):
            tr = self.traces[rid]
            out.append({
                "request_id": rid,
                "status": tr.status,
                "ttft": tr.ttft,
                "tpot": tr.tpot,
                "n_tokens": tr.n_tokens,
                "queue_wait_ticks": tr.queue_wait_ticks,
                "escalation_retries": tr.escalation_retries,
                "spans": [{"kind": s.kind, "tier": s.tier, "slot": s.slot,
                           "t0": s.t0, "t1": s.t1, **s.args}
                          for s in tr.spans],
            })
        return out

    def histogram_summary(self) -> Dict[str, Dict[str, float]]:
        return {name: h.summary() for name, h in self.hists.items()}

    def phase_summary(self) -> Dict[str, float]:
        """Cumulative wall seconds per tick-phase bucket."""
        return dict(self.phase_time)

    def prometheus_text(self) -> str:
        """Prometheus text-format snapshot (see module docstring for the
        key schema).  Every family carries ``# HELP`` + ``# TYPE`` lines,
        label values are escaped per the text exposition format, and the
        histograms' unbounded overflow bucket is folded into ``+Inf``
        (finite ``le`` edges stop at the last bounded bucket)."""
        lines: List[str] = []
        if self.counters is not None:
            for f in fields(self.counters):
                v = getattr(self.counters, f.name)
                metric = f"hi_{f.name}_total"
                lines.append(f"# HELP {metric} Cumulative scheduler "
                             f"counter '{f.name}'.")
                lines.append(f"# TYPE {metric} counter")
                lines.append(f"{metric} {v}")
        lines.append("# HELP hi_tick_phase_seconds_total "
                     f"{_HELP['hi_tick_phase_seconds_total']}")
        lines.append("# TYPE hi_tick_phase_seconds_total counter")
        for p in PHASES:
            lines.append(
                f'hi_tick_phase_seconds_total{{phase="{escape_label(p)}"}} '
                f"{self.phase_time.get(p, 0.0):.9f}")
        if self.ticks:
            lines.append(f"# HELP hi_gauge {_HELP['hi_gauge']}")
            lines.append("# TYPE hi_gauge gauge")
            for k, v in sorted(self.ticks[-1].gauges.items()):
                name, _, tier = k.partition("@")
                tag = f',tier="{escape_label(tier)}"' if tier else ""
                lines.append(
                    f'hi_gauge{{name="{escape_label(name)}"{tag}}} {v}')
        for name, h in self.hists.items():
            unit = h.unit
            metric = f"hi_{name}_{unit}"
            lines.append(f"# HELP {metric} "
                         f"{_HELP.get(name, f'{name} distribution.')}")
            lines.append(f"# TYPE {metric} histogram")
            cum = 0
            # the last bucket is the unbounded overflow: it must NOT emit a
            # finite ``le`` edge — its count reaches the +Inf line only
            last = h.n_buckets - 1
            for i, c in enumerate(h.counts):
                cum += c
                if c and i < last:
                    edge = h.upper_edge(i)
                    lines.append(f'{metric}_bucket{{le="{edge:g}"}} {cum}')
            lines.append(f'{metric}_bucket{{le="+Inf"}} {h.count}')
            lines.append(f"{metric}_sum {h.total:.9f}")
            lines.append(f"{metric}_count {h.count}")
        if self.audit is not None:
            lines.extend(self.audit.prometheus_lines())
        return "\n".join(lines) + "\n"
