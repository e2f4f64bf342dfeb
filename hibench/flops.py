"""Operation and byte counts, from shapes: the model's FLOPs per token and
the least work of one paged attention call.  Counted from what the inputs
need, never from what a kernel happens to read or compute."""
from __future__ import annotations

from hibench import peaks
from hibench.reference.dims import Dims, param_count


def attention_flops(dm: Dims, keys: int) -> float:
    """QK and PV of one query token over ``keys`` keys, every layer."""
    return 4.0 * dm.layers * dm.heads * dm.head_dim * keys


def request_flops(dm: Dims, prompt: int, generated: int) -> float:
    """Model FLOPs of one request on one tier: its ``prompt`` real prompt
    tokens (no bucket padding) and the ``generated - 1`` decode steps that
    follow the first token, each token attending over the real tokens up
    to itself.  Active parameters only (2 FLOPs each)."""
    steps = prompt + max(generated - 1, 0)
    keys = steps * (steps + 1) / 2          # sum over tokens of 1 .. steps
    return 2.0 * param_count(dm)["matmul"] * steps + attention_flops(dm, 1) * keys


def paged_call_bound(pairs: int, rows: int, q_shape, pool_shape,
                     itemsize: int) -> float:
    """Seconds one paged attention call needs at the card's peaks: q and the
    output once (float32), each valid K/V row once in the pool's dtype, or
    4 x H x D FLOPs per valid (query token, key) pair, the larger.
    ``q_shape`` (B, C, H, D), ``pool_shape`` (P, page, K, D)."""
    b, c, h, d = q_shape
    kv_heads = pool_shape[2]
    nbytes = 2 * 4 * b * c * h * d + 2 * rows * kv_heads * d * itemsize
    flops = 4.0 * h * d * pairs
    return max(nbytes / peaks.HBM_BYTES_PER_S, flops / peaks.BF16_FLOP_PER_S)
