"""copy_pages — copy-on-write page duplication over (L, P, ...) page pools.

Replaces the reference's ``kernels/decode_attention.py`` ``copy_pages_pallas``
over bf16, float32 and int8 page pools and the int8 pools' (L, P, K)
float32 scale rows, which move with their pages.  The TPU kernel streams
every one of the P pages, identity pages included, only to keep its grid
well-formed, and the reference calls it once per tensor; here only the real
(src, dst) pairs are copied, in place, across all L layers of up to four
tensors of a tier (K and V pools, K and V scale rows) in one launch.

* :func:`copy_pages_plain` — the plain PyTorch version with the reference's
  ``cow_copy_pages`` / ``cow_copy_scales`` semantics: in every tensor,
  pages ``dst`` become copies of pages ``src``, all read before any is
  written.
* :func:`copy_pages_cuda` — launches ``csrc/copy_pages.cu``;
  ``copy_pages_cuda.launches`` counts its launches over float32 and bf16
  pools, ``copy_pages_cuda.launches_int8`` those over int8 pools with their
  scale rows.

The pairs are host int arrays (the scheduler builds them on the host), so the
wrapper drops the (0, 0) pad pairs and checks on the host, before anything
reaches the card, that the real pairs' destinations are distinct and
disjoint from their sources: copies in place in any order then equal the
reference's read-everything-first copy.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import build

MAX_PAIRS = 256          # pairs per launch: they travel in the kernel's
#                          parameter block (csrc/copy_pages.cu kMaxPairs)
MAX_POOLS = 4            # csrc/copy_pages.cu kMaxTensors


def real_pairs(src, dst) -> Tuple[np.ndarray, np.ndarray]:
    """The non-pad pairs as int32 arrays, checked: a destination is never
    the null page, appears once, and is no pair's source."""
    src = np.asarray(src, np.int32).reshape(-1)
    dst = np.asarray(dst, np.int32).reshape(-1)
    if src.shape != dst.shape:
        raise ValueError(f"copy_pages: src {src.shape} and dst {dst.shape} "
                         "differ in length")
    keep = ~((src == 0) & (dst == 0))
    src, dst = src[keep], dst[keep]
    if (dst == 0).any():
        raise ValueError("copy_pages: a real pair writes the null page 0")
    if len(set(dst.tolist())) != len(dst):
        raise ValueError(f"copy_pages: destination pages repeat: {dst}")
    if set(dst.tolist()) & set(src.tolist()):
        raise ValueError("copy_pages: a destination page is also a source; "
                         "an in-place copy would depend on its order")
    return src, dst


def _check_pools(pools: Sequence[torch.Tensor]) -> None:
    """1..4 tensors (L, P, ...) on one device with the same L and P; their
    page shapes and dtypes may differ (pools and scale rows)."""
    if not 1 <= len(pools) <= MAX_POOLS:
        raise ValueError(f"copy_pages: 1..{MAX_POOLS} pools, got {len(pools)}")
    p0 = pools[0]
    if p0.ndim < 2:
        raise ValueError(f"copy_pages: pool {tuple(p0.shape)} must be "
                         "(L, P, ...)")
    for p in pools[1:]:
        if p.ndim < 2 or p.shape[:2] != p0.shape[:2] or p.device != p0.device:
            raise ValueError("copy_pages: pools must share (L, P) and device")


def copy_pages_plain(pools: Sequence[torch.Tensor], src, dst) -> None:
    """In place: ``pool[:, dst_i] = pool[:, src_i]`` for every pool."""
    _check_pools(pools)
    s, d = real_pairs(src, dst)
    if not len(d):
        return
    si = torch.as_tensor(s, dtype=torch.long, device=pools[0].device)
    di = torch.as_tensor(d, dtype=torch.long, device=pools[0].device)
    for pool in pools:
        pool[:, di] = pool[:, si]


def copy_pages_cuda(pools: Sequence[torch.Tensor], src, dst) -> None:
    """Launch the kernel (nothing is launched when every pair is padding).
    Pools: contiguous, distinct, on one CUDA device, of one (L, P); each
    moves in 16-byte vectors where its strides and base allow, else in
    4-byte words or bytes."""
    _check_pools(pools)
    p0 = pools[0]
    if p0.device.type != "cuda":
        raise ValueError(f"copy_pages_cuda needs CUDA tensors, got "
                         f"{p0.device}")
    if not all(p.is_contiguous() for p in pools):
        raise ValueError("copy_pages: pools must be contiguous")
    if len({p.data_ptr() for p in pools}) != len(pools):
        raise ValueError("copy_pages: a pool is passed twice")
    s, d = real_pairs(src, dst)
    n_pages = p0.shape[1]
    if len(d) and (s.min() < 0 or max(s.max(), d.max()) >= n_pages):
        raise ValueError(f"copy_pages: page ids outside 0..{n_pages - 1}")
    bases = (ctypes.c_void_p * len(pools))(*(p.data_ptr() for p in pools))
    layer_bytes = np.array([p[0].numel() * p.element_size() for p in pools],
                           np.int64)
    page_bytes = np.array([p[0, 0].numel() * p.element_size() for p in pools],
                          np.int64)
    int8 = any(p.dtype == torch.int8 for p in pools)
    lib = build.library()
    stream = torch.cuda.current_stream(p0.device).cuda_stream
    for at in range(0, len(d), MAX_PAIRS):
        sc = np.ascontiguousarray(s[at:at + MAX_PAIRS])
        dc = np.ascontiguousarray(d[at:at + MAX_PAIRS])
        err = lib.copy_pages_launch(
            bases, layer_bytes.ctypes.data_as(ctypes.c_void_p),
            page_bytes.ctypes.data_as(ctypes.c_void_p), len(pools),
            p0.shape[0], sc.ctypes.data_as(ctypes.c_void_p),
            dc.ctypes.data_as(ctypes.c_void_p), len(dc), stream)
        build.check(err, "copy_pages")
        if int8:
            copy_pages_cuda.launches_int8 += 1
        else:
            copy_pages_cuda.launches += 1


copy_pages_cuda.launches = 0
copy_pages_cuda.launches_int8 = 0
