"""Scheduler (``serving/scheduler.py``): host milliseconds a tick spends
inside CUDA runtime and driver calls (launches, copies, syncs, allocator
calls) within ``hi.dispatch`` ranges, over the traced wave's ``hi.tick``
ranges (``hibench/lanes.py``): what of ``dispatch`` waits on the runtime
rather than running Python and ATen."""


def read(ctx):
    lanes = getattr(ctx, "lanes", None)
    if not lanes or not lanes["device_ops"] or not lanes["ticks"]:
        return None
    return 1e3 * lanes["dispatch"]["runtime_s"] / lanes["ticks"]
