"""Scheduler (``serving/scheduler.py``): the share of the traced wave's
wall in which the device ran nothing while the host was inside a
``hi.<tier>.live`` range, the decode lanes (``hibench/lanes.py``)."""


def read(ctx):
    lanes = getattr(ctx, "lanes", None)
    if not lanes or not lanes["device_ops"] or lanes["window_s"] <= 0:
        return None
    idle = sum(r["idle_s"] for k, r in lanes["rows"].items()
               if k.endswith(".live"))
    return 100.0 * idle / lanes["window_s"]
