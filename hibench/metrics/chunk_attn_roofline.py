"""Kernels (``kernels/ops.py`` -> ``csrc/chunk_paged_attention.cu``): the
least time the traced wave's chunk-lane attention calls need at the card's peaks
(``hibench/flops.py``: q, the valid K/V rows once and the output, or their
FLOPs) over the kernel's device time in the trace."""

NAME = "decode_attention_chunk_paged"


def read(ctx):
    b = (ctx.kernel_bounds or {}).get(NAME)
    if not b or b["device_s"] <= 0:
        return None
    return 100.0 * b["bound_s"] / b["device_s"]
