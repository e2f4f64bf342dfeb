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
reference's read-everything-first copy.  A tick has a few pairs, so the
wrapper checks them as Python lists, and the launch's block of pointers and
strides (:func:`_launch_args`) is made once per tuple of pools and kept:
a tier's pools live as long as its scheduler.
"""
from __future__ import annotations

import array
import ctypes
from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import build

MAX_PAIRS = 256          # pairs per launch: they travel in the kernel's
#                          parameter block (csrc/copy_pages.cu kMaxPairs)
MAX_POOLS = 4            # csrc/copy_pages.cu kMaxTensors


def real_pairs(src, dst) -> Tuple[List[int], List[int]]:
    """The non-pad pairs as lists of ints (taken as int32), checked: a
    destination is never the null page, appears once, and is no pair's
    source."""
    src = np.asarray(src, np.int32).ravel().tolist()
    dst = np.asarray(dst, np.int32).ravel().tolist()
    if len(src) != len(dst):
        raise ValueError(f"copy_pages: src ({len(src)},) and dst "
                         f"({len(dst)},) differ in length")
    if 0 in src:                                 # drop the (0, 0) pads
        kept = [(s, d) for s, d in zip(src, dst) if s or d]
        src, dst = [s for s, _ in kept], [d for _, d in kept]
    if 0 in dst:
        raise ValueError("copy_pages: a real pair writes the null page 0")
    dset = set(dst)
    if len(dset) != len(dst):
        raise ValueError(f"copy_pages: destination pages repeat: "
                         f"{np.asarray(dst, np.int32)}")
    if not dset.isdisjoint(src):
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


class LaunchArgs:
    """What a launch over one tuple of pools needs besides the pairs:
    ``block`` holds the tensors' base addresses, then their layer strides
    and their page strides in bytes (int64 each; csrc/copy_pages.cu
    ``copy_pages_launch``), ``address`` is where it lies."""

    def __init__(self, pools: Sequence[torch.Tensor]):
        self.n_tensors = len(pools)
        self.layers, self.n_pages = pools[0].shape[:2]
        self.device = pools[0].get_device()     # -1 on the CPU
        self.int8 = any(p.dtype == torch.int8 for p in pools)
        self.bases = [p.data_ptr() for p in pools]
        self.layer_bytes = [p.stride(0) * p.element_size() for p in pools]
        self.page_bytes = [p.stride(1) * p.element_size() for p in pools]
        self.block = (ctypes.c_longlong * (3 * len(pools)))(
            *self.bases, *self.layer_bytes, *self.page_bytes)
        self.address = ctypes.addressof(self.block)


# LaunchArgs per tuple of pools, keyed on what it is computed from; at most
# _MAX_CACHED entries (a process that makes many pools starts afresh)
_ARGS: dict = {}
_MAX_CACHED = 64


def _pool_args(pools: Sequence[torch.Tensor]) -> LaunchArgs:
    """The launch block for ``pools``, checked and made on the first call
    with their addresses, shapes, strides and dtypes, and then kept: a
    reallocated pool is a new key."""
    # a device address is unique across devices (unified addressing)
    key = tuple((p.data_ptr(), p.shape, p.stride(), p.dtype) for p in pools)
    args = _ARGS.get(key)
    if args is None:
        _check_pools(pools)
        if not all(p.is_contiguous() for p in pools):
            raise ValueError("copy_pages: pools must be contiguous")
        if len({p.data_ptr() for p in pools}) != len(pools):
            raise ValueError("copy_pages: a pool is passed twice")
        args = LaunchArgs(pools)
        if len(_ARGS) >= _MAX_CACHED:
            _ARGS.clear()
        _ARGS[key] = args
    return args


def _launch_args(pools: Sequence[torch.Tensor], src, dst
                 ) -> Tuple[LaunchArgs, List[array.array]]:
    """The wrapper's host preparation, checked, with no device work (it runs
    on the CPU too): the pools' launch block, and the real pairs in int32
    buffers of at most ``MAX_PAIRS`` pairs (sources, then destinations), one
    per launch."""
    args = _pool_args(pools)
    s, d = real_pairs(src, dst)
    if d and (min(min(s), min(d)) < 0
              or max(max(s), max(d)) >= args.n_pages):
        raise ValueError(f"copy_pages: page ids outside 0..{args.n_pages - 1}")
    return args, [array.array("i", s[at:at + MAX_PAIRS] + d[at:at + MAX_PAIRS])
                  for at in range(0, len(d), MAX_PAIRS)]


def copy_pages_cuda(pools: Sequence[torch.Tensor], src, dst) -> None:
    """Launch the kernel (nothing is launched when every pair is padding).
    Pools: contiguous, distinct, on one CUDA device, of one (L, P); each
    moves in 16-byte vectors where its strides and base allow, else in
    4-byte words or bytes."""
    args, batches = _launch_args(pools, src, dst)
    if args.device < 0:
        raise ValueError(f"copy_pages_cuda needs CUDA tensors, got "
                         f"{pools[0].device}")
    launch = build.library().copy_pages_launch
    stream = build.current_stream(args.device)
    for pairs in batches:
        err = launch(args.address, args.n_tensors, args.layers,
                     pairs.buffer_info()[0], len(pairs) // 2, stream)
        build.check(err, "copy_pages")
        if args.int8:
            copy_pages_cuda.launches_int8 += 1
        else:
            copy_pages_cuda.launches += 1


copy_pages_cuda.launches = 0
copy_pages_cuda.launches_int8 = 0
