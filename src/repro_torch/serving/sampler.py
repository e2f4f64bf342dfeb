"""Token samplers.

Only greedy decoding is ported.  The reference samples at temperature > 0
with per-request, per-token threefry keys (``jax.random.fold_in``), which
torch's generators do not reproduce; whether the port implements threefry
for exact key parity or holds distributional parity is an open ROADMAP item
(Queue A item 4).
"""
from __future__ import annotations

import torch


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """(B, V) -> (B,) int64 token ids (first index of the max)."""
    return logits.argmax(dim=-1)


def sample(logits: torch.Tensor, temp: float) -> torch.Tensor:
    """Greedy at ``temp <= 0``; temperature sampling is not ported yet."""
    if temp > 0:
        raise NotImplementedError(
            "temperature sampling is not ported (ROADMAP Queue A item 4: "
            "threefry key parity or distributional parity)")
    return greedy(logits)
