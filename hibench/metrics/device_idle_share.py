"""Device (H100): the share of the traced wave's wall in which no kernel,
memcpy or memset ran (``hibench/trace.py``'s union of intervals)."""


def read(ctx):
    t = ctx.trace
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
