"""ssd_scan — the Mamba-2 SSD intra-chunk terms (the quadratic hot spot of
every SSM and hybrid prefill).

Replaces the reference's ``kernels/ssd_scan.py`` ``ssd_chunk_pallas`` (body
``_kernel``).  Per (batch row, chunk) of Q positions, with ``a = dt * A``
and ``a_cs`` its cumulative sum over the chunk:

  y_diag[i,h,p] = sum_{j<=i} (C_i . B_j) exp(a_cs[i,h] - a_cs[j,h]) dt[j,h] x[j,h,p]
  S[h,p,n]      = sum_j exp(a_cs[Q-1,h] - a_cs[j,h]) dt[j,h] x[j,h,p] B[j,n]
  g[h]          = exp(a_cs[Q-1,h])
  exp_acs[i,h]  = exp(a_cs[i,h])

The inter-chunk recurrence that consumes S and g stays in plain torch
(``ops.ssd``), as the reference leaves it outside Pallas.

* :func:`ssd_chunk_ref` — the plain PyTorch version, the Pallas kernel's
  arithmetic: the (Q, Q) decay keeps i >= j by ``where`` (a select, never a
  multiply by a mask) on the difference and on its ``exp``, so the ``exp``
  of a positive difference above the diagonal, which may overflow, is
  never computed, and its backward stays finite.
* :func:`ssd_chunk_cuda` — launches ``csrc/ssd_scan.cu``, the three
  products on the tensor cores in three TF32 passes each, one block per
  (group of heads, chunk, batch row) with :func:`ssd_heads_per_block` heads
  sharing the block's C.B^T.  ``ssd_chunk_cuda.launches`` counts its
  launches.
* :class:`SSDChunk` — the kernel under autograd, for a training forward on
  the card: its forward launches the kernel; its backward recomputes
  :func:`ssd_chunk_ref` from the saved inputs and returns that VJP.  The
  reference has no backward kernel (its trainer differentiates the plain
  maths outside any Pallas call), so the backward is the same maths here;
  a hand-written backward kernel is queued with the kernel work (ROADMAP,
  open work on the ported kernels).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build

MAX_CHUNK = 128          # the kernel keeps C.B^T (Q, Q) in shared memory
MAX_HEAD_DIM = 128
MAX_STATE = 128
# one block per SM of an H100 (132 SMs), at most MAX_HEADS_PER_BLOCK heads
# a block (the kernel keeps their a_cs in shared memory)
TARGET_BLOCKS = 132
MAX_HEADS_PER_BLOCK = 8


def ssd_heads_per_block(b: int, nc: int, h: int) -> int:
    """Heads per block of the kernel, from the shapes alone: the fewest
    that keep the grid within ``TARGET_BLOCKS`` blocks, so that each block's
    C.B^T (and its copy of B) serves as many heads as the card's width
    allows, at most ``MAX_HEADS_PER_BLOCK``.  mamba2-370m's L admission
    (b 4, nc 4, H 32): 4 (128 blocks); its S tier (8, 4, 8): 2 (128);
    zamba2-2.7b's L (4, 2, 80): 5 (128)."""
    rows = b * nc
    top = min(h, MAX_HEADS_PER_BLOCK)
    for hb in range(1, top + 1):
        if rows * -(-h // hb) <= TARGET_BLOCKS:
            return hb
    return top


def ssd_chunk_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor) -> Out:
    """x: (b, nc, Q, H, P); dt: (b, nc, Q, H); A: (H,); B/C: (b, nc, Q, N).
    Returns (y_diag (b,nc,Q,H,P), S (b,nc,H,P,N), g (b,nc,H),
    exp_acs (b,nc,Q,H)), all float32."""
    x, dt, A = x.float(), dt.float(), A.float()
    B, C = B.float(), C.float()
    q = x.shape[2]
    a_cs = torch.cumsum(dt * A, dim=2)                         # (b,nc,Q,H)
    dx = x * dt[..., None]
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                device=x.device))[None, None, :, :, None]
    # above the diagonal the difference is zeroed before the exp, not only
    # after: the exp of a positive difference may overflow, and a select's
    # backward multiplies the inf by a zero cotangent (NaN).  The values
    # are the reference's; its ssd_chunked, which selects after the exp
    # only, gives NaN grads there (ROADMAP Queue C)
    diff = torch.where(tri, a_cs[:, :, :, None, :] - a_cs[:, :, None, :, :],
                       0.0)                                    # (b,nc,i,j,H)
    decay = torch.where(tri, torch.exp(diff), 0.0)
    cb = torch.einsum("bcin,bcjn->bcij", C, B)
    y = torch.einsum("bcij,bcijh,bcjhp->bcihp", cb, decay, dx)
    to_end = torch.exp(a_cs[:, :, -1:, :] - a_cs)              # (b,nc,Q,H)
    S = torch.einsum("bcjh,bcjhp,bcjn->bchpn", to_end, dx, B)
    return y, S, torch.exp(a_cs[:, :, -1, :]), torch.exp(a_cs)


def ssd_chunk_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor) -> Out:
    """Launch the kernel.  Shapes as :func:`ssd_chunk_ref`; every operand
    float32, contiguous, on one CUDA device; Q and P multiples of 8 up to
    128, N a multiple of 8 up to 128."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"ssd_chunk_cuda needs CUDA tensors, got {dev}")
    ops_ = (x, dt, A, B, C)
    if any(t.device != dev for t in ops_):
        raise ValueError("ssd_chunk: all operands must share a device")
    if any(t.dtype != torch.float32 for t in ops_):
        raise TypeError("ssd_chunk: every operand must be float32, got "
                        f"{[str(t.dtype) for t in ops_]}")
    if x.ndim != 5:
        raise ValueError(f"ssd_chunk: x {tuple(x.shape)} must be "
                         "(b, nc, Q, H, P)")
    b, nc, q, h, p = x.shape
    n = B.shape[-1]
    if (dt.shape != (b, nc, q, h) or A.shape != (h,)
            or B.shape != (b, nc, q, n) or C.shape != B.shape):
        raise ValueError(f"ssd_chunk: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)}, C {tuple(C.shape)} do not agree")
    if (q % 8 or not 8 <= q <= MAX_CHUNK or p % 8 or not 8 <= p <= MAX_HEAD_DIM
            or n % 8 or not 8 <= n <= MAX_STATE):
        raise ValueError(f"ssd_chunk: chunk {q}, head dim {p}, state {n} not "
                         f"supported by the kernel (multiples of 8, chunk <= "
                         f"{MAX_CHUNK}, head dim <= {MAX_HEAD_DIM}, state <= "
                         f"{MAX_STATE})")
    if not all(t.is_contiguous() for t in ops_):
        raise ValueError("ssd_chunk: operands must be contiguous")
    y = torch.empty((b, nc, q, h, p), dtype=torch.float32, device=dev)
    S = torch.empty((b, nc, h, p, n), dtype=torch.float32, device=dev)
    g = torch.empty((b, nc, h), dtype=torch.float32, device=dev)
    eacs = torch.empty((b, nc, q, h), dtype=torch.float32, device=dev)
    lib = build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.ssd_chunk_launch(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), y.data_ptr(), S.data_ptr(), g.data_ptr(),
        eacs.data_ptr(), b, nc, q, h, p, n, ssd_heads_per_block(b, nc, h),
        stream)
    build.check(err, "ssd_chunk")
    ssd_chunk_cuda.launches += 1
    return y, S, g, eacs


ssd_chunk_cuda.launches = 0


class SSDChunk(torch.autograd.Function):
    """:func:`ssd_chunk_cuda` with the VJP of :func:`ssd_chunk_ref`."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C):
        ctx.save_for_backward(x, dt, A, B, C)
        return ssd_chunk_cuda(x, dt, A, B, C)

    @staticmethod
    def backward(ctx, *grads):
        ins = [t.detach().requires_grad_(need)
               for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wrt = [t for t in ins if t.requires_grad]
        with torch.enable_grad():
            outs = ssd_chunk_ref(*ins)
        got = iter(torch.autograd.grad(outs, wrt, grads, allow_unused=True))
        return tuple(next(got) if t.requires_grad else None for t in ins)
