"""Model step (``models/moe.py`` -> ``kernels/grouped_ffn.py``): the share
of the traced wave's device busy time spent in the grouped expert
kernel's two launches, found by their names among the trace's device
operations (``hibench/trace.py``'s ``op_s``)."""

KERNELS = ("moe_gate_up_kernel", "moe_down_kernel")


def read(ctx):
    t = ctx.trace
    if not t or t["busy_s"] <= 0:
        return None
    s = sum(v for op, v in t["op_s"].items()
            if any(k in op for k in KERNELS))
    if s <= 0:
        return None
    return 100.0 * s / t["busy_s"]
