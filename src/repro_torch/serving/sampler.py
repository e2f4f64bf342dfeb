"""Token samplers, with the reference's per-request threefry keys.

``sample`` is the serving path's entry point: greedy when temperature <= 0
(exactly :func:`greedy`, which keeps the drain/stream equivalence tests
exact), categorical otherwise.  Keys are PER REQUEST and PER TOKEN INDEX
(:func:`request_keys`), so a request's sampled continuation depends only on
(request id, token index), never on its batch row, slot or tick: the
property that makes temperature serving testable across schedulers.

The keys and bits are jax's, bit for bit: threefry2x32 (Salmon et al., SC
2011) as ``jax._src.prng`` computes it, ``PRNGKey`` / ``fold_in`` /
``random_bits`` with ``jax_threefry_partitionable`` on (jax's default), and
``uniform`` / ``gumbel`` (mode "low") / ``categorical`` as
``jax._src.random`` builds them from those bits.  A counter-based generator
computed per row on the device is what gives the per-request contract
without a host loop; torch's generators are stateful and would not.

Representation: a key is an int64 tensor (..., 2) of two 32-bit words.
Every 32-bit word is held in int64 and masked to 32 bits after each add
(threefry needs only add, rotate and xor; torch's ``uint32`` lacks
arithmetic on some backends).  Everything runs on the logits' device as
plain torch; nothing reads a value back to the host.
"""
from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# float32: 23 mantissa bits; the smallest normal number
_NMANT = 23
_ONE_BITS = 0x3F800000
TINY = torch.finfo(torch.float32).tiny


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1, x2):
    """The 20-round threefry2x32 hash of the counter pairs (x1, x2) under
    the key (k1, k2).  Arguments broadcast; each holds 32-bit words in
    int64.  Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x1, x2


def prng_key(seed: torch.Tensor) -> torch.Tensor:
    """``jax.random.PRNGKey`` of 32-bit seeds: (...) -> (..., 2) int64, the
    words (seed >> 32, seed & 0xFFFFFFFF) = (0, seed as uint32)."""
    seed = torch.as_tensor(seed).to(torch.int64) & MASK
    return torch.stack([torch.zeros_like(seed), seed], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: the key hashed at the counter pair
    (0, data as uint32).  key (..., 2); data broadcasts against (...)."""
    data = torch.as_tensor(data).to(device=key.device,
                                    dtype=torch.int64) & MASK
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                          data)
    return torch.stack([y1, y2], dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` under partitionable threefry:
    the counters are the (hi, lo) 32-bit halves of a flat 64-bit iota over
    ``shape``, and the bits are the xor of the hash's two words.  key
    (..., 2) -> (..., *shape) int64 words."""
    shape = tuple(shape)
    n = 1
    for d in shape:
        n *= d
    iota = torch.arange(n, dtype=torch.int64, device=key.device)
    hi, lo = (iota >> 32).reshape(shape), (iota & MASK).reshape(shape)
    lead = key.shape[:-1]
    k1 = key[..., 0].reshape(lead + (1,) * len(shape))
    k2 = key[..., 1].reshape(lead + (1,) * len(shape))
    b1, b2 = threefry2x32(k1, k2, hi, lo)
    return b1 ^ b2


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: the top 23 bits as the mantissa of
    a float in [1, 2), less 1, scaled to [minval, maxval)."""
    bits = random_bits(key, shape)
    f = ((bits >> (32 - _NMANT)) | _ONE_BITS).to(torch.int32) \
        .view(torch.float32) - 1.0
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    return torch.clamp_min(f * span + lo, lo)


def gumbel(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.gumbel`` in mode "low", float32."""
    return -torch.log(-torch.log(uniform(key, shape, minval=TINY)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis (the Gumbel-max
    trick).  One key (2,) draws the whole logits shape; per-row keys
    (B, 2) draw each row of (B, V) logits from its own key."""
    if key.ndim == 1:
        g = gumbel(key, logits.shape)
    else:
        g = gumbel(key, logits.shape[key.ndim - 1:])
    return (g + logits).argmax(dim=-1)


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """(B, V) -> (B,) int64 token ids (first index of the max)."""
    return logits.argmax(dim=-1)


def temperature(key: torch.Tensor, logits: torch.Tensor,
                temp: float = 1.0) -> torch.Tensor:
    """One key for the whole batch (the reference's ``temperature``)."""
    if temp <= 0:
        return greedy(logits)
    return categorical(key, logits / temp)


def request_keys(seeds: torch.Tensor, token_idx) -> torch.Tensor:
    """Per-request, per-token keys: ``fold_in(PRNGKey(seed), token_idx)``.

    seeds: (B,) request-derived seeds (the request ids); token_idx: scalar
    or (B,) index of the token being sampled within each request's
    generation.  Returns (B, 2) int64 key words."""
    if isinstance(token_idx, torch.Tensor):
        idx = token_idx.to(torch.int64).expand(seeds.shape)
    else:       # filled on the device: no host->device copy
        idx = torch.full(seeds.shape, int(token_idx), dtype=torch.int64,
                         device=seeds.device)
    return fold_in(prng_key(seeds), idx)


def sample(keys: torch.Tensor, logits: torch.Tensor,
           temp: Union[float, torch.Tensor]) -> torch.Tensor:
    """keys: (B, 2); logits: (B, V); temp: a scalar or (B,) per row.

    A row with temp <= 0 takes :func:`greedy` exactly.  A Python temp <= 0
    skips the draw; a tensor temp computes it and selects per row, as the
    reference does."""
    if not isinstance(temp, torch.Tensor) and temp <= 0:
        return greedy(logits)
    b = logits.shape[0]
    if isinstance(temp, torch.Tensor):
        t = temp.to(torch.float32).expand(b)
    else:
        t = torch.full((b,), float(temp), dtype=torch.float32,
                       device=logits.device)
    scaled = logits / torch.clamp_min(t, 1e-6)[:, None]
    return torch.where(t > 0, categorical(keys, scaled), greedy(logits))
