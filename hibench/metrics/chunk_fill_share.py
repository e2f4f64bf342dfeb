"""Scheduler (``serving/scheduler.py``): the real prompt tokens both
tiers' chunk lanes fed over the W x C positions they computed on the ticks
they ran, across the window (the runtimes' ``chunk_tokens`` over
``chunk_positions``, ``hibench/lanes.py``'s ``chunk_fill``)."""


def read(ctx):
    fill = getattr(ctx, "chunk_fill", None)
    if not fill or not fill["positions"]:
        return None
    return 100.0 * fill["tokens"] / fill["positions"]
