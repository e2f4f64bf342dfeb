"""Scheduler: the share of the tick wall in the ``dispatch`` phase (the
host enqueuing the lanes' kernels), from the scheduler's telemetry
(``serving/telemetry.py``, host clock) over the window."""


def read(ctx):
    phases = ctx.phase_time
    if not phases or sum(phases.values()) <= 0:
        return None
    return 100.0 * phases.get("dispatch", 0.0) / sum(phases.values())
