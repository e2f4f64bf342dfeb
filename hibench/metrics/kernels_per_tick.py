"""Scheduler (``serving/scheduler.py``): the device kernels whose launching
runtime call lies inside a ``hi.dispatch`` range (by correlation id), over
the ``hi.tick`` ranges of the traced wave (``hibench/lanes.py``); copies
and memsets are not counted."""


def read(ctx):
    lanes = getattr(ctx, "lanes", None)
    if not lanes or not lanes["device_ops"] or not lanes["ticks"]:
        return None
    return lanes["dispatch"]["kernels"] / lanes["ticks"]
