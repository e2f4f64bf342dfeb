"""grouped_swiglu — the routed experts of a MoE layer as a grouped matrix
product over the experts that hold a (token, choice) pair.

It replaces no TPU kernel: the reference runs its routed FFN as three
batched ``einsum``s over capacity-bounded (E, cap, D) buffers, which read
every expert's weights and drop the pairs past an expert's capacity.  Here
the pairs are sorted by expert (``models/moe.py``) and every pair runs
through its expert, with no capacity and no drop, in float32 with TF32
off (IEEE products, as the configurations state).

Inputs: tokens ``x`` (T, D); ``pairs`` (P,) the pair ids t·k + j sorted by
expert, expert e's run being ``pairs[offsets[e]:offsets[e + 1]]`` and the
pairs past ``offsets[E]`` dead; ``gate`` (T·k,) by pair id; the experts'
``wg``/``wi`` (E, D, F) and ``wo`` (E, F, D).  Output (T·k, D) by pair id:
row t·k + j is ``gate[t·k + j] · (silu(x_t Wg_e) ⊙ x_t Wi_e) Wo_e`` for the
pair's expert e, and zero for a dead pair.

The pairs come from :func:`route_pairs`: the router's softmax over the E
experts, the top k (ties to the lower expert), the gates renormalised,
and the live tokens' pairs sorted by expert, stably (a dead token's pairs
last: it takes no expert work).

* :func:`route_pairs_plain` / :func:`grouped_swiglu_plain` — the plain
  PyTorch versions (the product one ``mm`` per expert hit, its offsets
  read on the host); the CPU path and the oracle on the card.
* :func:`route_pairs_cuda` — launches ``csrc/grouped_ffn.cu``'s
  ``moe_route_launch``: two kernels whatever the pass's size (the top k
  per token and each block's counts per expert, then a counting sort).
* :func:`grouped_swiglu_cuda` — launches its ``grouped_swiglu_launch``:
  ``moe_gate_up_kernel`` computes ``silu(x Wg) ⊙ (x Wi)`` over each
  expert's run of sorted rows (the rows gathered from ``x`` by token
  inside the kernel), ``moe_down_kernel`` multiplies by ``Wo``, scales by
  the gate and stores each row at its pair id.  The source's note says
  what bounds them and how the design serves both a decode step (a few
  rows an expert, bound by the weights' bytes) and the chunk lane (~192
  rows an expert, bound by float32 FMAs); the row tile follows the pass's
  mean run (:func:`tiles`) and the grid is sized from the shapes for the
  worst case, so nothing is read back to the host.

Each wrapper's ``launches`` counts its calls (two kernel launches each).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import build


def top_k_plain(logits: torch.Tensor, k: int):
    """Softmax over the E experts of ``logits`` (T, E), the top k in
    ``lax.top_k``'s order (descending, ties to the lower index), the gates
    renormalised: (gate (T, k), idx (T, k), probs (T, E))."""
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = gate[:, :k], idx[:, :k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return gate, idx, probs


def route_pairs_plain(logits: torch.Tensor, k: int,
                      live: Optional[torch.Tensor] = None):
    """The pairs of router ``logits`` (T, E) float32: (gate (T·k,) by pair
    id t·k + j, pairs (T·k,) the pair ids sorted by expert, stably, the
    dead tokens' (``live`` (T,) bool False) last, offsets (E + 1,) the
    experts' runs, ``offsets[E]`` the live pairs)."""
    e = logits.shape[-1]
    gate, idx, _ = top_k_plain(logits, k)
    if live is not None:
        idx = torch.where(live[:, None], idx, e)
    ids, pairs = torch.sort(idx.reshape(-1), stable=True)
    offsets = torch.searchsorted(ids, torch.arange(e + 1,
                                                   device=logits.device))
    return gate.reshape(-1), pairs, offsets


def grouped_swiglu_plain(x: torch.Tensor, pairs: torch.Tensor,
                         offsets: torch.Tensor, wg: torch.Tensor,
                         wi: torch.Tensor, wo: torch.Tensor,
                         gate: torch.Tensor, k: int) -> torch.Tensor:
    """One product per expert hit, in the kernel's order of operations.
    On ``meta`` tensors: shapes only."""
    out = x.new_zeros((pairs.shape[0], x.shape[1]))
    if x.device.type == "meta":
        return out
    off = offsets.tolist()
    for e in range(len(off) - 1):
        lo, hi = off[e], off[e + 1]
        if lo == hi:
            continue
        p = pairs[lo:hi].long()
        xs = x[p // k]
        h = F.silu(xs @ wg[e]) * (xs @ wi[e])
        out[p] = (h @ wo[e]) * gate[p, None]
    return out


# the row tiles of csrc/grouped_ffn.cu's kernels
ROW_TILES = (8, 32, 64)


def tiles(pairs: int, experts: int):
    """(BLOCK_M, worst-case row tiles) of a pass of ``pairs`` pairs over
    ``experts`` experts.  The row tile follows the mean run: 8 rows up to
    16 pairs an expert (a decode step's 1–12), 32 up to 48 (a chunk lane
    of one or two rows, ~24–48), else 64 (~96–768 at four or eight rows).
    Each expert holding a pair adds at most one partial tile, and no tile
    is empty."""
    mean = pairs / experts
    bm = ROW_TILES[0] if mean <= 16 else ROW_TILES[1] if mean <= 48 \
        else ROW_TILES[2]
    return bm, min(pairs, -(-pairs // bm) + experts)


# csrc/grouped_ffn.cu: tokens per routing block (kRouteTokens), the most
# experts (kMaxExperts: E + 1 buckets, one a thread) and choices (kMaxK)
ROUTE_TOKENS = 32
MAX_EXPERTS = 255
MAX_K = 32


def route_pairs_cuda(logits: torch.Tensor, k: int,
                     live: Optional[torch.Tensor] = None):
    """:func:`route_pairs_plain`'s outputs on the card, from the two
    kernels of ``moe_route_launch`` (one call, whatever the pass's size);
    no host sync."""
    t, e = logits.shape
    if not (logits.is_cuda and logits.dtype == torch.float32
            and logits.stride(1) == 1 and 1 <= e <= MAX_EXPERTS
            and 1 <= k <= min(e, MAX_K) and t >= 1
            and (live is None or (live.shape == (t,)
                                  and live.dtype == torch.bool
                                  and live.device == logits.device))):
        raise ValueError(f"route_pairs_cuda: logits {tuple(logits.shape)} "
                         f"{logits.dtype}, k {k}, live "
                         f"{None if live is None else tuple(live.shape)}")
    dev = logits.device
    blocks = -(-t // ROUTE_TOKENS)
    gate = torch.empty((t * k,), dtype=torch.float32, device=dev)
    pairs = torch.empty((t * k,), dtype=torch.int64, device=dev)
    offsets = torch.empty((e + 1,), dtype=torch.int64, device=dev)
    bucket = torch.empty((t * k,), dtype=torch.int32, device=dev)
    counts = torch.empty((blocks * (e + 1),), dtype=torch.int32, device=dev)
    live_ptr = None if live is None else live.contiguous().data_ptr()
    err = build.library().moe_route_launch(
        logits.data_ptr(), logits.stride(0), live_ptr, t, e, k,
        gate.data_ptr(), pairs.data_ptr(), offsets.data_ptr(),
        bucket.data_ptr(), counts.data_ptr(), build.current_stream(dev.index))
    build.check(err, "moe_route")
    route_pairs_cuda.launches += 1
    return gate, pairs, offsets


route_pairs_cuda.launches = 0


def _aligned(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0


def grouped_swiglu_cuda(x: torch.Tensor, pairs: torch.Tensor,
                        offsets: torch.Tensor, wg: torch.Tensor,
                        wi: torch.Tensor, wo: torch.Tensor,
                        gate: torch.Tensor, k: int) -> torch.Tensor:
    """The two kernels of ``grouped_swiglu_launch`` on the current stream;
    no host sync."""
    e, d, f = wg.shape
    p = pairs.shape[0]
    f32 = torch.float32
    if not (x.is_cuda and x.dim() == 2 and x.shape[1] == d
            and x.stride(1) == 1 and x.stride(0) % 4 == 0
            and d % 4 == 0 and f % 4 == 0 and pairs.dtype == torch.int64
            and offsets.dtype == torch.int64
            and offsets.shape == (e + 1,) and gate.shape == (p,)
            and wi.shape == wg.shape and wo.shape == (e, f, d)
            and all(t.dtype == f32 for t in (x, wg, wi, wo, gate))
            and all(t.is_contiguous() and _aligned(t) for t in (wg, wi, wo))
            and _aligned(x) and pairs.is_contiguous()
            and offsets.is_contiguous() and gate.is_contiguous()
            and x.shape[0] * k == p):
        raise ValueError(
            f"grouped_swiglu_cuda: x {tuple(x.shape)} {x.dtype}, pairs "
            f"{tuple(pairs.shape)} {pairs.dtype}, offsets "
            f"{tuple(offsets.shape)}, gate {tuple(gate.shape)}, experts "
            f"{tuple(wg.shape)} / {tuple(wo.shape)} {wg.dtype}, k {k}")
    bm, m_tiles = tiles(p, e)
    h = torch.empty((p, f), dtype=f32, device=x.device)
    out = torch.zeros((p, d), dtype=f32, device=x.device)
    err = build.library().grouped_swiglu_launch(
        x.data_ptr(), x.stride(0), pairs.data_ptr(), offsets.data_ptr(),
        wg.data_ptr(), wi.data_ptr(), wo.data_ptr(), gate.data_ptr(),
        h.data_ptr(), out.data_ptr(), d, f, e, k, bm, m_tiles,
        build.current_stream(x.device.index))
    build.check(err, "grouped_swiglu")
    grouped_swiglu_cuda.launches += 1
    return out


grouped_swiglu_cuda.launches = 0
