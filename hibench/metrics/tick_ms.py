"""Scheduler (``serving/scheduler.py``): wall milliseconds per tick, the
window's seconds over the scheduler's ``ticks`` counter across it."""


def read(ctx):
    if not ctx.ticks:
        return None
    return 1e3 * ctx.window_s / ctx.ticks
