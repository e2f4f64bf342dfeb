"""Static-capacity sample router — HI's offload with fixed device shapes.

"Offload the complex samples" becomes: pick the ``capacity`` highest-priority
samples (priority = wants-offload first, then lowest confidence), gather them
into a fixed (capacity, ...) batch for the L tier, and scatter-merge the L
tier's outputs back.  Samples that want offload but exceed capacity are
*dropped escalations* (served with the S-tier result) and counted.

Everything stays on the tensors' device; nothing here reads a value back to
the host.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class RouteDecision(NamedTuple):
    indices: torch.Tensor       # (C,) int64 — positions gathered for the L tier
    valid: torch.Tensor         # (C,) bool  — gathered slot actually wants offload
    offload_mask: torch.Tensor  # (N,) bool  — the policy's raw decision
    served_remote: torch.Tensor  # (N,) bool — offloaded AND within capacity
    dropped: torch.Tensor       # ()   int32 — wanted offload, no capacity


def route(offload_mask: torch.Tensor, conf: torch.Tensor,
          capacity: int) -> RouteDecision:
    """offload_mask, conf: (N,).  capacity: python int <= N."""
    n = offload_mask.shape[0]
    if not 0 < capacity <= n:
        raise ValueError(f"capacity {capacity} must be in (0, {n}]")
    prio = torch.where(offload_mask, 2.0 - conf, -conf)
    # The reference ranks with lax.top_k, which breaks ties toward the lower
    # index; torch.topk does not, a stable descending sort does.  Ties are
    # common: the batcher fills empty rows with identical pad prompts.
    idx = torch.sort(prio, descending=True, stable=True).indices[:capacity]
    valid = offload_mask[idx]
    served = torch.zeros_like(offload_mask).index_put((idx,), valid)
    dropped = (offload_mask.sum() - valid.sum()).to(torch.int32)
    return RouteDecision(idx, valid, offload_mask, served, dropped)


def gather(x: torch.Tensor, decision: RouteDecision) -> torch.Tensor:
    """(N, ...) -> (C, ...) complex-sample batch for the L tier."""
    return x[decision.indices]


def scatter_merge(s_out: torch.Tensor, l_out: torch.Tensor,
                  decision: RouteDecision) -> torch.Tensor:
    """Merge L-tier outputs over S-tier outputs at the served positions.

    s_out: (N, ...); l_out: (C, ...) aligned with decision.indices.
    """
    idx = decision.indices
    upd = torch.where(decision.valid.reshape((-1,) + (1,) * (l_out.ndim - 1)),
                      l_out, s_out[idx])
    return s_out.index_put((idx,), upd)


def agreement(s_out: torch.Tensor, l_out: torch.Tensor,
              decision: RouteDecision) -> torch.Tensor:
    """Per-slot S/L agreement over the gathered batch -> (C,) bool.

    The online policy's correctness proxy (paper ref [27]): the ED never
    sees ground truth, so S/L agreement on the escalated samples stands in.
    """
    eq = s_out[decision.indices] == l_out
    return eq.flatten(1).all(dim=1) if l_out.ndim > 1 else eq


def capacity_for(batch: int, capacity_factor: float) -> int:
    return max(1, min(batch, int(round(batch * capacity_factor))))
