"""Decision-quality observability: the gate audit stream, online calibration
monitors and the SLO watchdog.

The port's copy of the reference's ``serving/audit.py``.  The paper's
objection to HI is that the edge device cannot know whether its local
inference suffices, so the health of a deployed HI system is the health of
the gate's calibration.  Everything here reads what the tick's one
``_host_fetch`` already brought back: the audit adds no device sync and no
shape, and when absent each scheduler hook is one ``is None`` branch.

* :class:`GateAudit`: one :class:`AuditRecord` per gate evaluation the
  scheduler absorbs (kinds ``admit`` / ``chunk`` / ``decode`` per token,
  ``block`` for a speculative draft block, ``request`` for the
  request-level decision), with the theta in effect (``FAIL_LOCAL_THETA``
  while the breaker is open); ground truth from the speculative verify lane
  (kind ``draft``, one per emitted position) and from completed
  escalations (kind ``l_agree``).  Streaming aggregates: reliability bins
  with ``np.histogram``'s bin rule, running ECE and offload rate per
  ``Request.tclass``, a theta-margin histogram, and empirical regret
  against the verify-lane oracle.
* :class:`SLOThresholds` / :class:`SLOWatchdog`: TTFT / TPOT p95, L-queue
  depth and calibration-drift limits evaluated once a tick; breaches become
  telemetry instant events and flight-recorder dumps.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np

from repro_torch.serving.telemetry import escape_label


class AuditRecord(NamedTuple):
    """One gate decision (the bounded raw-stream face of the audit)."""
    rid: int
    tier: str                 # "S" / "L"
    tclass: str               # Request.tclass traffic-class tag
    kind: str                 # admit / chunk / decode / block / request /
    #                           draft / l_agree
    conf: float
    theta: float              # theta IN EFFECT (FAIL_LOCAL_THETA when open)
    offload: bool             # the gate's decision at that theta
    ok: Optional[bool] = None  # ground truth when the verify lane ran


class ReliabilityBins:
    """Streaming correct/incorrect counts per confidence bin.

    Bin semantics are ``core/calibrate.p_histogram``'s: edges are
    ``np.linspace(0, 1, bins + 1)``, every bin is half-open ``[lo, hi)``
    except the last (closed at 1.0) — ``np.histogram``'s rule, so the
    streaming counts match the NumPy oracle sample for sample
    (the port's observability tests cross-check)."""

    def __init__(self, bins: int = 20):
        self.bins = int(bins)
        self.edges = np.linspace(0.0, 1.0, self.bins + 1)
        self.correct = np.zeros(self.bins, np.int64)
        self.incorrect = np.zeros(self.bins, np.int64)
        self.conf_sum = np.zeros(self.bins, np.float64)

    def _idx(self, conf: float) -> int:
        # searchsorted(side="right") - 1 == np.histogram's bin rule; the
        # clip folds conf == 1.0 into the (closed) last bin
        i = int(np.searchsorted(self.edges, conf, side="right")) - 1
        return min(max(i, 0), self.bins - 1)

    def record(self, conf: float, ok: bool) -> None:
        i = self._idx(conf)
        (self.correct if ok else self.incorrect)[i] += 1
        self.conf_sum[i] += conf

    @property
    def count(self) -> int:
        return int(self.correct.sum() + self.incorrect.sum())

    def ece(self) -> float:
        """Expected calibration error: sum_b (n_b/N) |acc_b - mean conf_b|."""
        n_b = self.correct + self.incorrect
        n = n_b.sum()
        if n == 0:
            return 0.0
        live = n_b > 0
        acc = self.correct[live] / n_b[live]
        mean_conf = self.conf_sum[live] / n_b[live]
        return float(np.sum(n_b[live] / n * np.abs(acc - mean_conf)))

    def as_dict(self) -> Dict[str, np.ndarray]:
        """`p_histogram`-shaped view: edges / correct / incorrect."""
        return {"edges": self.edges.copy(),
                "correct": self.correct.copy(),
                "incorrect": self.incorrect.copy()}


class _ClassStats:
    """Per-traffic-class aggregates."""

    def __init__(self, bins: int):
        self.evals = 0            # every gate evaluation (all kinds)
        self.requests = 0         # request-level decisions
        self.offloaded = 0        # ... that offloaded
        self.bins = ReliabilityBins(bins)

    @property
    def offload_rate(self) -> float:
        return self.offloaded / self.requests if self.requests else 0.0


class GateAudit:
    """Per-decision gate audit stream + streaming calibration monitors.

    Install via ``serve_stream(..., audit=GateAudit())`` (or
    ``ContinuousScheduler.set_audit``).  Host-side only: never part of the
    scheduler's compile key, zero device traffic, zero overhead when absent.

    ``bins`` sets the reliability-bin count (shared semantics with
    ``core/calibrate.p_histogram``); ``beta`` is the paper's offload cost in
    [0, 1) for the empirical-regret counter (default = ``HIConfig.beta``);
    ``max_records`` bounds the raw :class:`AuditRecord` ring (aggregates are
    exact regardless)."""

    def __init__(self, *, bins: int = 20, beta: float = 0.5,
                 margin_bins: int = 40, max_records: int = 65536):
        self.beta = float(beta)
        self.records: deque = deque(maxlen=int(max_records))
        self.overall = ReliabilityBins(bins)
        self.classes: Dict[str, _ClassStats] = {}
        self._bins = int(bins)
        # theta-margin histogram: linear bins over conf - theta in [-1, 1]
        self.margin_bins = int(margin_bins)
        self.margin_edges = np.linspace(-1.0, 1.0, self.margin_bins + 1)
        self.margin_counts = np.zeros(self.margin_bins, np.int64)
        self.decisions = 0
        self.outcomes = 0
        self.wasted_offload = 0     # offloaded though S was right
        self.missed_local = 0       # served local though S was wrong
        self.regret_cost = 0.0      # gate cost - oracle cost, paper units

    # -- scheduler hooks ----------------------------------------------------

    def _class(self, tclass: str) -> _ClassStats:
        cs = self.classes.get(tclass)
        if cs is None:
            cs = self.classes[tclass] = _ClassStats(self._bins)
        return cs

    def _margin(self, conf: float, theta: float) -> None:
        m = conf - theta
        i = int(np.searchsorted(self.margin_edges, m, side="right")) - 1
        self.margin_counts[min(max(i, 0), self.margin_bins - 1)] += 1

    def decision(self, *, rid: int, tier: str, tclass: str, kind: str,
                 conf: float, theta: float,
                 offload: Optional[bool] = None) -> None:
        """One gate evaluation.  ``theta`` is the threshold IN EFFECT for
        the decision (``FAIL_LOCAL_THETA`` while the breaker is open).
        ``offload`` defaults to ``conf < theta``; pass it explicitly where
        the decision is not a plain comparison (e.g. the speculative
        request-level roll-up)."""
        if offload is None:
            offload = conf < theta
        self.decisions += 1
        self._margin(conf, theta)
        cs = self._class(tclass)
        cs.evals += 1
        if kind == "request":
            cs.requests += 1
            cs.offloaded += bool(offload)
        self.records.append(AuditRecord(rid, tier, tclass, kind,
                                        float(conf), float(theta),
                                        bool(offload)))

    def outcome(self, *, rid: int, tier: str, tclass: str, conf: float,
                theta: float, ok: bool, kind: str = "draft") -> None:
        """One ground-truthed decision: the verify lane (kind ``draft``) or
        a completed escalation's S/L agreement (kind ``l_agree``).  Feeds
        the reliability bins, running ECE, and the empirical-regret
        counters."""
        ok = bool(ok)
        offload = conf < theta
        self.outcomes += 1
        self.overall.record(conf, ok)
        self._class(tclass).bins.record(conf, ok)
        # gate cost: beta per offload, 1 per wrong local answer; the oracle
        # (which sees ``ok``) pays min(beta, 1 - ok)
        if offload and ok:
            self.wasted_offload += 1
            self.regret_cost += self.beta
        elif not offload and not ok:
            self.missed_local += 1
            self.regret_cost += 1.0 - self.beta
        self.records.append(AuditRecord(rid, tier, tclass, kind,
                                        float(conf), float(theta),
                                        offload, ok))

    # -- exporters ----------------------------------------------------------

    def ece(self, tclass: Optional[str] = None) -> float:
        if tclass is None:
            return self.overall.ece()
        cs = self.classes.get(tclass)
        return cs.bins.ece() if cs is not None else 0.0

    def offload_rate(self, tclass: Optional[str] = None) -> float:
        if tclass is not None:
            cs = self.classes.get(tclass)
            return cs.offload_rate if cs is not None else 0.0
        req = sum(c.requests for c in self.classes.values())
        off = sum(c.offloaded for c in self.classes.values())
        return off / req if req else 0.0

    def reliability(self, tclass: Optional[str] = None
                    ) -> Dict[str, np.ndarray]:
        """``p_histogram``-shaped reliability bins (edges / correct /
        incorrect), overall or for one traffic class."""
        if tclass is None:
            return self.overall.as_dict()
        cs = self.classes.get(tclass)
        return cs.bins.as_dict() if cs is not None \
            else ReliabilityBins(self._bins).as_dict()

    def gauge_values(self) -> Dict[str, float]:
        """Compact per-tick aggregates — merged into the telemetry gauges,
        which makes them Chrome-trace counter tracks and flight-recorder
        snapshot fields for free.  All values are deterministic functions of
        the decision stream."""
        return {
            "audit_decisions": float(self.decisions),
            "audit_outcomes": float(self.outcomes),
            "audit_ece": round(self.overall.ece(), 9),
            "audit_offload_rate": round(self.offload_rate(), 9),
            "audit_regret_cost": round(self.regret_cost, 9),
            "audit_wasted_offload": float(self.wasted_offload),
            "audit_missed_local": float(self.missed_local),
        }

    def summary(self) -> Dict[str, Any]:
        return {
            "decisions": self.decisions,
            "outcomes": self.outcomes,
            "ece": self.overall.ece(),
            "offload_rate": self.offload_rate(),
            "regret": {"wasted_offload": self.wasted_offload,
                       "missed_local": self.missed_local,
                       "cost": self.regret_cost, "beta": self.beta},
            "classes": {
                t: {"evals": c.evals, "requests": c.requests,
                    "offloaded": c.offloaded,
                    "offload_rate": c.offload_rate,
                    "ece": c.bins.ece(), "outcomes": c.bins.count}
                for t, c in sorted(self.classes.items())},
        }

    def prometheus_lines(self) -> List[str]:
        """``hi_audit_*`` metric families, appended by
        ``Telemetry.prometheus_text`` when an audit is installed."""
        L: List[str] = []

        def fam(metric: str, mtype: str, help_: str) -> None:
            L.append(f"# HELP {metric} {help_}")
            L.append(f"# TYPE {metric} {mtype}")

        fam("hi_audit_decisions_total", "counter",
            "Gate decisions recorded by the audit stream.")
        L.append(f"hi_audit_decisions_total {self.decisions}")
        fam("hi_audit_outcomes_total", "counter",
            "Ground-truthed decisions (verify lane / L agreement).")
        L.append(f"hi_audit_outcomes_total {self.outcomes}")
        fam("hi_audit_regret_total", "counter",
            "Gate mistakes vs the verify-lane oracle, by kind.")
        L.append(f'hi_audit_regret_total{{kind="wasted_offload"}} '
                 f"{self.wasted_offload}")
        L.append(f'hi_audit_regret_total{{kind="missed_local"}} '
                 f"{self.missed_local}")
        fam("hi_audit_regret_cost", "counter",
            "Cumulative empirical regret vs the oracle (paper cost units).")
        L.append(f"hi_audit_regret_cost {self.regret_cost:.9f}")
        fam("hi_audit_ece", "gauge",
            "Running expected calibration error per traffic class "
            '(tclass="" = overall).')
        L.append(f'hi_audit_ece{{tclass=""}} {self.overall.ece():.9f}')
        for t, c in sorted(self.classes.items()):
            if t:
                L.append(f'hi_audit_ece{{tclass="{escape_label(t)}"}} '
                         f"{c.bins.ece():.9f}")
        fam("hi_audit_offload_rate", "gauge",
            "Offload rate over request-level gate decisions per traffic "
            'class (tclass="" = overall).')
        L.append(f'hi_audit_offload_rate{{tclass=""}} '
                 f"{self.offload_rate():.9f}")
        for t, c in sorted(self.classes.items()):
            if t:
                L.append(
                    f'hi_audit_offload_rate{{tclass="{escape_label(t)}"}} '
                    f"{c.offload_rate:.9f}")
        fam("hi_audit_reliability_total", "counter",
            "Correct/incorrect counts per confidence bin "
            "(p_histogram bin semantics).")
        for i in range(self._bins):
            lo, hi = self.overall.edges[i], self.overall.edges[i + 1]
            for outcome, arr in (("correct", self.overall.correct),
                                 ("incorrect", self.overall.incorrect)):
                if arr[i]:
                    L.append(
                        f'hi_audit_reliability_total{{bin="{lo:g}-{hi:g}",'
                        f'outcome="{outcome}"}} {int(arr[i])}')
        fam("hi_audit_theta_margin", "histogram",
            "Gate margin (conf - theta_in_effect) per decision.")
        cum = 0
        for i in range(self.margin_bins):
            cum += int(self.margin_counts[i])
            if self.margin_counts[i] and i < self.margin_bins - 1:
                L.append(f'hi_audit_theta_margin_bucket'
                         f'{{le="{self.margin_edges[i + 1]:g}"}} {cum}')
        L.append(f'hi_audit_theta_margin_bucket{{le="+Inf"}} '
                 f"{int(self.margin_counts.sum())}")
        L.append(f"hi_audit_theta_margin_count "
                 f"{int(self.margin_counts.sum())}")
        return L


# ---------------------------------------------------------------------------
# SLO watchdog
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SLOThresholds:
    """Watchdog limits; ``None`` disables a check.

    ``ttft_p95`` / ``tpot_p95`` are seconds against the telemetry
    histograms (need ``telemetry=`` installed); ``queue_depth`` bounds the
    L escalation queue; ``ece_max`` / ``offload_rate_max`` bound
    calibration drift against the audit stream (need ``audit=`` installed,
    evaluated once at least ``min_outcomes`` / ``min_requests`` ground
    truth samples exist)."""
    ttft_p95: Optional[float] = None
    tpot_p95: Optional[float] = None
    queue_depth: Optional[int] = None
    ece_max: Optional[float] = None
    offload_rate_max: Optional[float] = None
    min_outcomes: int = 20
    min_requests: int = 5


class SLOWatchdog:
    """Once-per-tick SLO evaluation over host state the scheduler already
    holds.  Breaches are appended to :attr:`breaches` (one dict per breach
    per tick: ``tick`` / ``kind`` / ``value`` / ``limit``), surfaced as
    telemetry instant events (Chrome ``i`` markers) and flight-recorder
    dump triggers by the scheduler."""

    def __init__(self, thresholds: SLOThresholds):
        self.thresholds = thresholds
        self.breaches: List[Dict[str, Any]] = []

    def evaluate(self, tick: int, *, tel=None, audit=None,
                 gauges: Optional[Dict[str, float]] = None
                 ) -> List[Dict[str, Any]]:
        th = self.thresholds
        found: List[Dict[str, Any]] = []

        def breach(kind: str, value: float, limit: float) -> None:
            found.append({"tick": tick, "kind": kind,
                          "value": float(value), "limit": float(limit)})

        if tel is not None:
            for name, limit in (("ttft", th.ttft_p95),
                                ("tpot", th.tpot_p95)):
                h = tel.hists.get(name)
                if limit is not None and h is not None and h.count:
                    v = h.quantile(0.95)
                    if v > limit:
                        breach(f"{name}_p95", v, limit)
        if gauges is not None and th.queue_depth is not None:
            v = gauges.get("l_queue_depth", 0.0)
            if v > th.queue_depth:
                breach("queue_depth", v, th.queue_depth)
        if audit is not None:
            if th.ece_max is not None and audit.outcomes >= th.min_outcomes:
                v = audit.ece()
                if v > th.ece_max:
                    breach("ece", v, th.ece_max)
            if th.offload_rate_max is not None:
                req = sum(c.requests for c in audit.classes.values())
                if req >= th.min_requests:
                    v = audit.offload_rate()
                    if v > th.offload_rate_max:
                        breach("offload_rate", v, th.offload_rate_max)
        self.breaches.extend(found)
        return found
