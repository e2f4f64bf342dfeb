"""Router and gate (``core/router.py``, ``kernels/hi_gate.py``): the share
of the window's requests whose S-tier confidence fell below theta and
escalated (the records' ``offloaded``).  Theta is set at set-up from the
S tier's confidences on the same requests served alone, so the share is
the cell's ``offload_share`` by design while the window's S tier gives
those confidences again: a change that moves the served confidences away
from the S tier's own (batching, prefix sharing, the gate) moves it."""


def read(ctx):
    if not ctx.requests:
        return None
    return 100.0 * sum(r["offloaded"] for r in ctx.requests) / len(ctx.requests)
