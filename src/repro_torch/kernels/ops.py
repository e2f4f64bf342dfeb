"""Public kernel entry points, chosen by device.

On a CPU tensor each op runs its kernel's plain PyTorch version; on a CUDA
tensor it launches the hand-written kernel or raises.  There is no switch
that turns the kernels off on the card and no fallback from a failed build
or launch to the plain version.

On a ``meta`` tensor (the dry run, ``launch/dryrun.py``) an op computes
shapes only and launches nothing: the plain version runs on the meta
tensors, except for :func:`decode_attention`, whose plain version upcasts
the whole cache to float32 and so would count twice the bytes the kernel
reads.  On meta it is the shape-only op ``repro_torch::decode_attention``,
which ``launch/counting.py`` counts as the kernel's work: the cache read
once in its own dtype, 4 x B x H x S x D operations.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.kernels import copy_pages as _cp
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import grouped_ffn as _gf
from repro_torch.kernels import hi_gate as _hg
from repro_torch.kernels import ssd_scan as _ssd

# kernel name -> (the wrapper, the counter attribute its launches bump).
# The int8 bodies count apart from the float32/bf16 ones.
KERNELS = {"hi_gate": (_hg.hi_gate_cuda, "launches"),
           "decode_attention": (_da.decode_attention_cuda, "launches"),
           "decode_attention_paged": (_da.decode_attention_paged_cuda,
                                      "launches"),
           "decode_attention_chunk_paged": (
               _da.decode_attention_chunk_paged_cuda, "launches"),
           "copy_pages": (_cp.copy_pages_cuda, "launches"),
           "ssd_chunk": (_ssd.ssd_chunk_cuda, "launches"),
           "decode_attention_paged[int8]": (_da.decode_attention_paged_cuda,
                                            "launches_int8"),
           "decode_attention_chunk_paged[int8]": (
               _da.decode_attention_chunk_paged_cuda, "launches_int8"),
           "copy_pages[int8]": (_cp.copy_pages_cuda, "launches_int8"),
           "grouped_swiglu": (_gf.grouped_swiglu_cuda, "launches"),
           "route_pairs": (_gf.route_pairs_cuda, "launches")}


def _on_cpu(t: torch.Tensor) -> bool:
    """True where the op runs its plain version: on the CPU, and on
    ``meta``, where it computes shapes only."""
    if t.device.type in ("cpu", "meta"):
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"no kernel for device {t.device}")


@torch.library.custom_op("repro_torch::decode_attention", mutates_args=())
def _decode_attention_shape(q: torch.Tensor, cache_k: torch.Tensor,
                            cache_v: torch.Tensor,
                            valid: torch.Tensor) -> torch.Tensor:
    """The drain kernel's call on ``meta`` tensors: shapes only."""
    raise ValueError(f"repro_torch::decode_attention is shape-only, got "
                     f"{q.device}")


@_decode_attention_shape.register_fake
def _(q, cache_k, cache_v, valid):
    return torch.empty_like(q)


def hi_gate(logits: torch.Tensor, theta: Union[float, torch.Tensor],
            metric: str = "max_prob"
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused confidence + argmax + threshold.  logits: (N, C).

    On the card ``theta`` must be a 0-d float32 device tensor: the kernel
    reads it through a pointer, so an online policy moves it without a
    host round trip."""
    if _on_cpu(logits):
        return _hg.hi_gate_plain(logits, theta, metric)
    return _hg.hi_gate_cuda(logits, theta, metric)


def decode_attention(q: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """Flash decode attention.  q: (B,1,H,D); cache: (B,S,K,D); valid: (S,)."""
    if q.device.type == "meta":
        return _decode_attention_shape(q, cache_k, cache_v, valid)
    if _on_cpu(q):
        return _da.decode_attention_plain(q, cache_k, cache_v, valid)
    return _da.decode_attention_cuda(q, cache_k, cache_v, valid)


def decode_attention_paged(q: torch.Tensor, pool_k: torch.Tensor,
                           pool_v: torch.Tensor, block: torch.Tensor,
                           valid: torch.Tensor,
                           scale_k: Optional[torch.Tensor] = None,
                           scale_v: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Flash decode attention over a paged pool.  q: (B,1,H,D); pools:
    (P, page, K, D); block: (B, n_pages); valid: (B, n_pages * page);
    scale_k/v: (P, K) float32 for int8 pools, else None."""
    if _on_cpu(q):
        return _da.decode_attention_paged_plain(q, pool_k, pool_v, block,
                                                valid, scale_k, scale_v)
    return _da.decode_attention_paged_cuda(q, pool_k, pool_v, block, valid,
                                           scale_k, scale_v)


def decode_attention_chunk_paged(q: torch.Tensor, pool_k: torch.Tensor,
                                 pool_v: torch.Tensor, block: torch.Tensor,
                                 valid: torch.Tensor,
                                 scale_k: Optional[torch.Tensor] = None,
                                 scale_v: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """C query tokens per slot in one pass over its pages.  q: (B,C,H,D);
    valid: (B, C, n_pages * page) positional + intra-chunk causal mask;
    scales as :func:`decode_attention_paged`."""
    if _on_cpu(q):
        return _da.decode_attention_chunk_paged_plain(
            q, pool_k, pool_v, block, valid, scale_k, scale_v)
    return _da.decode_attention_chunk_paged_cuda(q, pool_k, pool_v, block,
                                                 valid, scale_k, scale_v)


def copy_pages(pools: Sequence[torch.Tensor], src, dst) -> None:
    """Copy-on-write, in place: in every (L, P, ...) tensor (pools and
    scale rows, up to four), pages ``dst`` become copies of pages ``src``
    (host int arrays, (0, 0) pairs pad)."""
    if _on_cpu(pools[0]):
        return _cp.copy_pages_plain(pools, src, dst)
    return _cp.copy_pages_cuda(pools, src, dst)


def ssd_chunk(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
              B: torch.Tensor, C: torch.Tensor):
    """The SSD intra-chunk terms (see ``ssd_scan.py``).  x: (b, nc, Q, H, P);
    dt: (b, nc, Q, H); A: (H,); B/C: (b, nc, Q, N), float32.  On the card
    a call that autograd records (a training forward) goes through
    ``SSDChunk``, the kernel with the plain version's VJP; serving, under
    ``inference_mode``, launches the kernel alone."""
    if _on_cpu(x):
        return _ssd.ssd_chunk_ref(x, dt, A, B, C)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A, B, C)):
        return _ssd.SSDChunk.apply(x, dt, A, B, C)
    return _ssd.ssd_chunk_cuda(x, dt, A, B, C)


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
        C: torch.Tensor, chunk: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD: the intra-chunk kernel, then the inter-chunk recurrence
    and its ``y_off`` term in plain torch, as the reference's ``ops.ssd``.

    x: (b, l, h, p); dt: (b, l, h); A: (h,); B/C: (b, l, n).  The sequence
    is padded to a multiple of the chunk with dt = 0 steps (decay 1, zero
    input: a no-op on the state).  A sequence shorter than the chunk is one
    chunk, as in the reference, rounded up to a multiple of 8 positions
    (the kernel's tile) by the same no-op steps.  Returns (y (b, l, h, p)
    in x's dtype, final state (b, h, p, n) float32)."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    chunk = min(chunk, -(-l // 8) * 8)
    orig_l = l
    if l % chunk:
        pad = chunk - l % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
        l += pad
    nc = l // chunk
    f32 = torch.float32
    xc = x.to(f32).reshape(b, nc, chunk, h, p).contiguous()
    dtc = dt.to(f32).reshape(b, nc, chunk, h).contiguous()
    Bc = B.to(f32).reshape(b, nc, chunk, n).contiguous()
    Cc = C.to(f32).reshape(b, nc, chunk, n).contiguous()
    y_diag, S, g, eacs = ssd_chunk(xc, dtc, A.to(f32).contiguous(), Bc, Cc)
    # inter-chunk linear recurrence (nc steps over (b, h, p, n))
    hprev = torch.zeros((b, h, p, n), dtype=f32, device=x.device)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(hprev)
        hprev = g[:, c, :, None, None] * hprev + S[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)                 # (b, nc, h, p, n)
    y_off = torch.einsum("bcih,bcin,bchpn->bcihp", eacs, Cc, h_prevs)
    y = (y_diag + y_off).reshape(b, l, h, p)[:, :orig_l]
    return y.to(x.dtype), hprev


def route_pairs(logits: torch.Tensor, k: int,
                live: Optional[torch.Tensor] = None):
    """A MoE pass's routed pairs from its router logits (T, E) float32:
    (gate (T·k,) by pair id, pairs (T·k,) sorted by expert, offsets
    (E + 1,)); ``live`` (T,) bool, the tokens that route (see
    ``grouped_ffn.py``)."""
    if _on_cpu(logits):
        return _gf.route_pairs_plain(logits, k, live)
    return _gf.route_pairs_cuda(logits, k, live)


def grouped_swiglu(x: torch.Tensor, pairs: torch.Tensor,
                   offsets: torch.Tensor, wg: torch.Tensor, wi: torch.Tensor,
                   wo: torch.Tensor, gate: torch.Tensor, k: int
                   ) -> torch.Tensor:
    """The routed experts over pairs sorted by expert (see
    ``grouped_ffn.py``): x (T, D); pairs (T·k,) pair ids; offsets (E + 1,)
    the experts' runs; experts (E, D, F) / (E, F, D); gate (T·k,).
    Returns (T·k, D) by pair id, zero for the dead pairs past
    ``offsets[E]``."""
    if _on_cpu(x):
        return _gf.grouped_swiglu_plain(x, pairs, offsets, wg, wi, wo, gate,
                                        k)
    return _gf.grouped_swiglu_cuda(x, pairs, offsets, wg, wi, wo, gate, k)


def launch_counts() -> Dict[str, int]:
    return {name: getattr(fn, attr) for name, (fn, attr) in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn, attr in KERNELS.values():
        setattr(fn, attr, 0)


def add_launch_counts(delta: Dict[str, int]) -> None:
    """Add ``delta`` (kernel name -> launches) to the counters: a CUDA
    graph's replay launches what its capture recorded without calling the
    wrappers (``serving/lane_graphs.py``)."""
    for name, n in delta.items():
        fn, attr = KERNELS[name]
        setattr(fn, attr, getattr(fn, attr) + n)


# the entry points above, as this module defines them: a caller may
# replace one (tests count or fault them; the benchmark tallies the paged
# kernels' work), and a captured CUDA graph would not see that
ENTRY_POINTS = ("hi_gate", "decode_attention", "decode_attention_paged",
                "decode_attention_chunk_paged", "copy_pages", "ssd_chunk",
                "ssd", "route_pairs", "grouped_swiglu")
_DEFINED = tuple(globals()[name] for name in ENTRY_POINTS)


def replaced() -> bool:
    """Whether any of ``ENTRY_POINTS`` is not the function defined here."""
    mod = globals()
    return any(mod[name] is not fn
               for name, fn in zip(ENTRY_POINTS, _DEFINED))
