"""Fault model for the S->L escalation path (host-side only).

The port's copy of the reference's ``serving/faults.py``: the per-request
status vocabulary (:data:`STATUSES`), the seeded transport-fault schedule
(:class:`FaultSchedule`, :data:`NO_FAULTS`), the retry policy, the simulated
ED<->ES link (:class:`EscalationLink`) and the circuit breaker.  The
scheduler passes every escalation through the link and the breaker, under
:data:`NO_FAULTS` too, so escalation timing, ``queue_wait_ticks`` and the
record fields are the reference's; ``serve_stream(faults=..., retry=...)``
installs a schedule and a policy for one call.  None of it touches the
device: faults change which requests the lanes serve and the tick's theta
operand, never a tensor shape.

Every decision is a pure function of ``(seed, request_id, attempt)`` or of
the run-relative tick, so a replayed run sees the identical fault sequence.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import numpy as np

# Every serve_stream result record carries exactly one of these:
#   ok            — served normally (locally, or remotely after escalation);
#   degraded_local— the request wanted escalation but the L path failed
#                   (loss/timeout retries exhausted, outage, open breaker,
#                   or L admission starvation): the S-tier answer stands;
#   dropped       — the arXiv:2112.11413 budget policy expired the queued
#                   escalation: the S-tier answer stands;
#   rejected      — admission gave up (page demand unsatisfiable after
#                   ``admit_retry_limit`` fruitless ticks): no tokens.
STATUSES = ("ok", "degraded_local", "dropped", "rejected")

# Fail-local gate threshold: every confidence metric lives in [0, 1] (see
# core/confidence.py), so ``conf < 0.0`` never offloads.  Passed as the tick
# executable's theta OPERAND while the breaker is open — same compiled
# program, the gate simply stops firing.
FAIL_LOCAL_THETA = 0.0


@dataclass(frozen=True)
class FaultSchedule:
    """Seeded, deterministic ED↔ES transport faults (all host-side).

    ``delay_ticks``/``delay_jitter`` — delivery delay of an escalation in
    scheduler ticks: base plus a per-(request, attempt) uniform draw from
    ``0..delay_jitter``.
    ``loss_prob`` — probability an escalation send is lost outright (the
    host only learns via ack timeout).
    ``outages`` — ``(a, b)`` windows of RUN-RELATIVE ticks during which the
    L tier is down: escalations queued at or arriving at the ES fail, and
    in-flight L-tier work is aborted (its slot and KV pages released).
    ``spikes`` — windows during which the L tier stalls (latency spike):
    arrivals queue but nothing is admitted; budgets keep running.
    """
    seed: int = 0
    delay_ticks: int = 0
    delay_jitter: int = 0
    loss_prob: float = 0.0
    outages: Tuple[Tuple[int, int], ...] = ()
    spikes: Tuple[Tuple[int, int], ...] = ()

    @property
    def active(self) -> bool:
        return (self.delay_ticks > 0 or self.delay_jitter > 0
                or self.loss_prob > 0 or bool(self.outages)
                or bool(self.spikes))

    def _unit(self, *parts: int) -> float:
        """Uniform [0, 1) from (seed, *parts) — order-independent."""
        h = hashlib.blake2b(
            np.asarray([self.seed, *parts], np.int64).tobytes(),
            digest_size=8)
        return int.from_bytes(h.digest(), "little") / 2.0 ** 64

    def transit(self, request_id: int, attempt: int) -> Optional[int]:
        """Delivery delay in ticks for this (request, attempt) send, or
        None when the escalation is lost on the wire."""
        if self._unit(request_id, attempt, 0) < self.loss_prob:
            return None
        d = self.delay_ticks
        if self.delay_jitter:
            d += int(self._unit(request_id, attempt, 1)
                     * (self.delay_jitter + 1))
        return d

    def in_outage(self, tick: int) -> bool:
        return any(a <= tick < b for a, b in self.outages)

    def in_spike(self, tick: int) -> bool:
        return any(a <= tick < b for a, b in self.spikes)

    def l_paused(self, tick: int) -> bool:
        """Is L-tier admission stalled this tick (outage or spike)?"""
        return self.in_outage(tick) or self.in_spike(tick)


NO_FAULTS = FaultSchedule()


@dataclass(frozen=True)
class RetryPolicy:
    """Resilience knobs for the escalation path (host-side, per run).

    Retries use capped exponential backoff: attempt ``n`` (1-based) resends
    ``min(backoff_base_ticks << (n - 1), backoff_cap_ticks)`` ticks after
    the failure.  ``admit_retry_limit`` bounds the ADMISSION retry spin: a
    request whose page demand stays unsatisfiable for that many fruitless
    ticks fails with ``status="rejected"`` instead of spinning forever.
    """
    ack_timeout_ticks: int = 4
    max_retries: int = 3
    backoff_base_ticks: int = 1
    backoff_cap_ticks: int = 8
    breaker_threshold: int = 3
    breaker_cooldown_ticks: int = 8
    admit_retry_limit: int = 64

    def backoff(self, attempt: int) -> int:
        return min(self.backoff_base_ticks << max(attempt - 1, 0),
                   self.backoff_cap_ticks)


@dataclass
class Escalation:
    """One S→L escalation's transport state (host bookkeeping only)."""
    adm: Any                      # batcher.AdmittedRequest
    rid: int
    created_tick: int             # run-relative tick of the S finish
    attempt: int = 0              # completed (failed) send attempts
    sent_tick: int = -1
    arrive_tick: Optional[int] = None   # None = lost / will time out
    resend_tick: int = -1
    l_admit_tick: int = -1


class EscalationLink:
    """Simulated ED↔ES transport: in-flight sends + backoff retries.

    The scheduler ``send()``s an escalation, then each tick ``step()``
    partitions the in-flight set into arrivals (delivered to the L queue)
    and failures (lost sends past their ack timeout, or deliveries landing
    inside an outage window).  Failed escalations the scheduler decides to
    retry re-enter through ``schedule_retry`` and are re-sent when due.
    """

    def __init__(self, faults: FaultSchedule, policy: RetryPolicy):
        self.faults = faults
        self.policy = policy
        self.in_flight: List[Escalation] = []
        self.backoff: List[Escalation] = []
        self.lost = 0

    @property
    def pending(self) -> int:
        return len(self.in_flight) + len(self.backoff)

    def send(self, esc: Escalation, tick: int) -> None:
        esc.sent_tick = tick
        d = self.faults.transit(esc.rid, esc.attempt)
        if d is None or d > self.policy.ack_timeout_ticks:
            # lost outright, or so late the host retransmits first — either
            # way the ack timeout is what the scheduler observes
            esc.arrive_tick = None
            self.lost += 1
        else:
            esc.arrive_tick = tick + d
        self.in_flight.append(esc)

    def step(self, tick: int) -> Tuple[List[Escalation], List[Escalation]]:
        """Advance the transport to ``tick``: (arrived, failed)."""
        arrived: List[Escalation] = []
        failed: List[Escalation] = []
        keep: List[Escalation] = []
        for esc in self.in_flight:
            if esc.arrive_tick is not None and esc.arrive_tick <= tick:
                # delivery into an outage window fails (ES down)
                (failed if self.faults.in_outage(tick)
                 else arrived).append(esc)
            elif esc.arrive_tick is None and \
                    tick - esc.sent_tick >= self.policy.ack_timeout_ticks:
                failed.append(esc)
            else:
                keep.append(esc)
        self.in_flight = keep
        return arrived, failed

    def schedule_retry(self, esc: Escalation, tick: int) -> None:
        esc.attempt += 1
        esc.resend_tick = tick + self.policy.backoff(esc.attempt)
        self.backoff.append(esc)

    def due_resends(self, tick: int) -> List[Escalation]:
        return [e for e in self.backoff if e.resend_tick <= tick]

    def take(self, esc: Escalation) -> Escalation:
        """Remove ``esc`` from the backoff set (about to resend or give
        up)."""
        self.backoff.remove(esc)
        return esc


class CircuitBreaker:
    """closed → open → half-open over consecutive L-path failures.

    * closed: escalations flow normally; each success resets the failure
      count, ``breaker_threshold`` CONSECUTIVE failures open the breaker.
    * open: fail-local mode — nothing is admitted to L, resends hold, and
      the scheduler's gate stops offloading (theta operand =
      :data:`FAIL_LOCAL_THETA`).  After ``breaker_cooldown_ticks`` the
      breaker half-opens.
    * half-open: exactly ONE trial escalation (the probe) is re-admitted.
      Its success closes the breaker; any failure re-opens it (cooldown
      restarts).
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"
    # numeric encoding for telemetry gauges / Chrome-trace counter tracks
    STATE_IDS = {CLOSED: 0, OPEN: 1, HALF_OPEN: 2}

    def __init__(self, policy: RetryPolicy):
        self.policy = policy
        self.state = self.CLOSED
        self.failures = 0
        self.opened_tick = -1
        self.opens = 0

    @property
    def closed(self) -> bool:
        return self.state == self.CLOSED

    @property
    def state_id(self) -> int:
        """Numeric state (0=closed, 1=open, 2=half_open) for gauge export."""
        return self.STATE_IDS[self.state]

    def state_at(self, tick: int) -> str:
        """Current state, applying the open → half-open cooldown edge."""
        if self.state == self.OPEN and \
                tick - self.opened_tick >= self.policy.breaker_cooldown_ticks:
            self.state = self.HALF_OPEN
        return self.state

    def record_failure(self, tick: int) -> None:
        self.failures += 1
        if self.state == self.HALF_OPEN or \
                (self.state == self.CLOSED
                 and self.failures >= self.policy.breaker_threshold):
            self.state = self.OPEN
            self.opened_tick = tick
            self.opens += 1
        elif self.state == self.OPEN:
            self.opened_tick = tick      # failures while open extend cooldown

    def record_success(self) -> None:
        self.failures = 0
        self.state = self.CLOSED
