"""The least time of the MoE family's grouped expert kernel
(``repro_torch/kernels/grouped_ffn.py``: ``moe_gate_up_kernel`` and
``moe_down_kernel``) on one H100, from what its inputs need.

A call runs ``pairs`` (token, choice) pairs of ``tokens`` live tokens
through the ``experts_hit`` experts that hold a pair (model width ``d``,
expert width ``f``).  It has to read each hit expert's three weight
matrices once, each live token's row once, and write one output row per
pair, at 3.35 TB/s; or do 2·3·d·f FLOPs a pair on the float32 FMA units
(67 TFLOP/s: the configurations run float32 with TF32 off), whichever
takes longer.  Its intermediate (the pairs' ``silu(x Wg) ⊙ x Wi`` rows)
is the kernel's own choice and is not counted.
"""
from __future__ import annotations

from hibench import peaks


def call_bytes(pairs: int, tokens: int, experts_hit: int, d: int, f: int,
               itemsize: int = 4) -> float:
    return itemsize * (3.0 * experts_hit * d * f + tokens * d + pairs * d)


def call_flops(pairs: int, d: int, f: int) -> float:
    return 2.0 * 3.0 * d * f * pairs


def call_bound(pairs: int, tokens: int, experts_hit: int, d: int, f: int,
               itemsize: int = 4) -> float:
    """Seconds one call needs at the card's peaks."""
    return max(call_bytes(pairs, tokens, experts_hit, d, f, itemsize)
               / peaks.HBM_BYTES_PER_S,
               call_flops(pairs, d, f) / peaks.F32_FLOP_PER_S)
