"""decode_attention — flash-decode GQA of one query token over a contiguous
KV cache, with a shared (S,) validity mask (position and sliding window),
and its paged variants for continuous serving.

Replaces the reference's ``kernels/decode_attention.py``
``decode_attention_pallas`` and ``decode_attention_paged_pallas`` and
``decode_attention_chunk_paged_pallas`` with their int8 bodies (see the
second half of this module).  ``copy_pages_pallas`` is ported in
``copy_pages.py``.

* :func:`decode_attention_plain` — the plain PyTorch version, following the
  Pallas kernel's arithmetic: q stays float32, K/V are upcast to float32
  (the reference's jnp path ``layers._sdpa`` would instead cast q to the
  cache dtype), masked scores are -1e30 with their probability zeroed, and
  the result is ``acc / max(l, 1e-30)``.
* :func:`decode_attention_cuda` — launches ``csrc/decode_attention.cu``:
  the cache positions split across blocks (:func:`drain_split_len` picks
  the split from the shapes alone), each split's partial (m, l, acc) in a
  float32 workspace the wrapper allocates with ``torch.empty``, then a
  small kernel that merges the splits in a fixed order.
  ``decode_attention_cuda.launches`` counts its calls, one per call.
* :func:`decode_attention_paged_cuda` — the paged decode kernel,
  ``csrc/decode_attention_paged.cu``: each slot's keys split into ranges
  of whole logical pages (:func:`paged_split_pages`, from the shapes
  alone), one block each, merged in split order by the last block of each
  (slot, kv head) to finish; one launch a call.
* :func:`decode_attention_chunk_paged_cuda` — the chunk kernel,
  ``csrc/chunk_paged_attention.cu``, on the tensor cores, through its own
  C entry point for C > 1; the first launch of each instantiation raises
  the kernel's dynamic shared-memory limit with ``cudaFuncSetAttribute``,
  and every call returns that call's error as it does the launch's.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import build

_NEG = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 80, 120, 128, 256)
MAX_GROUP = 8


def _check_heads(h: int, kh: int) -> int:
    if h % kh:
        raise ValueError(f"query heads H={h} not divisible by kv heads K={kh}")
    return h // kh


# the drain kernel's position splits: 32-position units, merged until the
# grid holds about two blocks per SM of an H100 (132 SMs), at most 256
SPLIT_UNIT = 32
SPLIT_TARGET_BLOCKS = 264
MAX_SPLITS = 256


def drain_split_len(b: int, kh: int, s: int) -> int:
    """Positions per split of the drain kernel, from the shapes alone (the
    mask's content would need a copy to the host): B*K blocks per split,
    about ``SPLIT_TARGET_BLOCKS`` in all, each split a whole number of
    ``SPLIT_UNIT``s.  At the L tier (B 4, K 2, S 1,024): 32, 256 blocks."""
    units = -(-s // SPLIT_UNIT)
    n = max(1, min(units, -(-SPLIT_TARGET_BLOCKS // (b * kh)), MAX_SPLITS))
    return SPLIT_UNIT * -(-units // n)


# the paged decode kernel's key splits: whole logical pages, at least
# SPLIT_UNIT positions each, merged until the grid holds about two blocks
# per SM; a split holds at most PAGED_MAX_SPLIT_PAGES pages and
# PAGED_MAX_SPLIT_POSITIONS positions (the kernel stages its block-table
# entries, scales and mask bits up front), at most MAX_SPLITS of them
PAGED_MAX_SPLIT_PAGES = 64
PAGED_MAX_SPLIT_POSITIONS = 1024


def paged_split_pages(b: int, kh: int, n_pages: int, page: int) -> int:
    """Pages per key split of the paged decode kernel, from the shapes alone
    (the mask and the block table would need a copy to the host): B*K
    blocks per split, about ``SPLIT_TARGET_BLOCKS`` in all.  At qwen2's L
    and S decode (B*K 8, 34 pages of 16): 2 pages, 17 splits, 136 blocks;
    at zamba2's (B*K 128, 18 pages): 6 pages, 3 splits.  Raises where a
    slot's pages do not fit ``MAX_SPLITS`` splits of the largest size."""
    cap = min(PAGED_MAX_SPLIT_PAGES, PAGED_MAX_SPLIT_POSITIONS // page)
    if cap < 1 or -(-n_pages // cap) > MAX_SPLITS:
        raise ValueError(f"decode_attention_paged: {n_pages} pages of {page} "
                         f"exceed the kernel's {MAX_SPLITS} splits of at most"
                         f" {PAGED_MAX_SPLIT_PAGES} pages and "
                         f"{PAGED_MAX_SPLIT_POSITIONS} positions")
    want = max(1, min(n_pages, -(-SPLIT_TARGET_BLOCKS // (b * kh)),
                      MAX_SPLITS))
    per = max(-(-n_pages // want), -(-SPLIT_UNIT // page))
    return min(per, cap)


def decode_attention_plain(q: torch.Tensor, cache_k: torch.Tensor,
                           cache_v: torch.Tensor,
                           valid: torch.Tensor) -> torch.Tensor:
    """q: (B, 1, H, D); cache_k/v: (B, S, K, D); valid: (S,) bool.
    Returns (B, 1, H, D) in q's dtype (float32 accumulation)."""
    b, _, h, d = q.shape
    kh = cache_k.shape[2]
    g = _check_heads(h, kh)
    qg = q.reshape(b, kh, g, d).float()
    scores = torch.einsum("bkgd,bskd->bkgs", qg, cache_k.float()) \
        * (1.0 / math.sqrt(d))
    scores = torch.where(valid, scores, _NEG)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m) * valid.float()
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgs,bskd->bkgd", p, cache_v.float())
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, 1, h, d).to(q.dtype)


def decode_attention_cuda(q: torch.Tensor, cache_k: torch.Tensor,
                          cache_v: torch.Tensor,
                          valid: torch.Tensor) -> torch.Tensor:
    """Launch the kernel.  Shapes as :func:`decode_attention_plain`; every
    tensor contiguous on one CUDA device; K/V float32 or bfloat16 of one
    dtype, each starting on a 16-byte boundary; D in ``HEAD_DIMS``;
    H/K <= ``MAX_GROUP``."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"decode_attention_cuda needs CUDA tensors, got {dev}")
    if any(t.device != dev for t in (cache_k, cache_v, valid)):
        raise ValueError("decode_attention: all operands must share a device")
    if cache_k.dtype not in _DTYPES or cache_v.dtype != cache_k.dtype:
        raise TypeError(f"decode_attention: cache dtypes {cache_k.dtype}/"
                        f"{cache_v.dtype}; need one of float32, bfloat16")
    if valid.dtype != torch.bool:
        raise TypeError(f"decode_attention: valid must be bool, got "
                        f"{valid.dtype}")
    if q.ndim != 4 or q.shape[1] != 1 or cache_k.ndim != 4:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} must be "
                         f"(B,1,H,D) and the cache (B,S,K,D)")
    b, _, h, d = q.shape
    s, kh = cache_k.shape[1], cache_k.shape[2]
    if (cache_k.shape != (b, s, kh, d) or cache_v.shape != cache_k.shape
            or valid.shape != (s,)):
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(cache_k.shape)}, v {tuple(cache_v.shape)}, "
                         f"valid {tuple(valid.shape)} do not agree")
    g = _check_heads(h, kh)
    if d not in HEAD_DIMS or g > MAX_GROUP:
        raise ValueError(f"decode_attention: head dim {d} (need one of "
                         f"{HEAD_DIMS}) or group {g} (need <= {MAX_GROUP}) "
                         f"not supported by the kernel")
    if not all(t.is_contiguous() for t in (cache_k, cache_v, valid)):
        raise ValueError("decode_attention: cache and mask must be contiguous")
    # K/V rows are staged with 16-byte loads; q is read a float at a time
    if cache_k.data_ptr() % 16 or cache_v.data_ptr() % 16:
        raise ValueError("decode_attention: cache_k and cache_v must start "
                         "on a 16-byte boundary")
    q32 = q.float().contiguous()
    out = torch.empty((b, 1, h, d), dtype=torch.float32, device=dev)
    split = drain_split_len(b, kh, s)
    # each split's (acc (G, D), m (G), l (G)) per (batch row, kv head)
    ws = torch.empty((b * kh * -(-s // split) * g * (d + 2),),
                     dtype=torch.float32, device=dev)
    lib = build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.decode_attention_launch(
        q32.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
        valid.data_ptr(), ws.data_ptr(), out.data_ptr(),
        _DTYPES[cache_k.dtype], b, s, kh, g, d, split, 1.0 / math.sqrt(d),
        stream)
    build.check(err, "decode_attention")
    decode_attention_cuda.launches += 1
    return out.to(q.dtype)


decode_attention_cuda.launches = 0


# ---------------------------------------------------------------------------
# paged variants: walk each slot's pages through an int32 block table
# ---------------------------------------------------------------------------
#
# Replace the reference's ``decode_attention_paged_pallas`` (bodies
# ``_paged_kernel`` and, for int8 pools, ``_paged_kernel_quant``) and
# ``decode_attention_chunk_paged_pallas`` (``_chunk_paged_kernel`` and
# ``_chunk_paged_kernel_quant``).  One query token per slot launches the
# decode kernel of ``csrc/decode_attention_paged.cu``; C > 1 launches the
# tensor-core kernel of ``csrc/chunk_paged_attention.cu``, each through its
# own C entry point.  An int8 pool comes with
# ``scale_k``/``scale_v`` (P, K) float32,
# one scale per physical page and kv head: a key row dequantises to
# ``float(int8) * scale[page, head]`` before the float32 online softmax.
# A key position that no query of the slot may see (page 0, pages not
# allocated, stale page tails) may hold anything, inf or NaN included, and
# so may its page's scale: both versions skip it, or select it out, and
# never multiply it by 0.  Keys are always seen by some query wherever a
# chunk's queries see them, so only keys visible to no query of the slot
# may hold such garbage.

PAGED_HEAD_DIMS = (32, 64, 80, 120, 128, 256)
_PAGED_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _check_pool_dtypes(name: str, pool_k: torch.Tensor, pool_v: torch.Tensor,
                       scale_k: Optional[torch.Tensor],
                       scale_v: Optional[torch.Tensor]) -> None:
    """One pool dtype of float32, bfloat16 or int8; an int8 pool, and only
    an int8 pool, comes with both (P, K) float32 scale tensors."""
    if pool_k.dtype not in _PAGED_DTYPES or pool_v.dtype != pool_k.dtype:
        raise TypeError(f"{name}: pool dtypes {pool_k.dtype}/{pool_v.dtype};"
                        " need one of float32, bfloat16, int8")
    quant = pool_k.dtype == torch.int8
    if quant != (scale_k is not None) or quant != (scale_v is not None):
        raise ValueError(f"{name}: an int8 pool needs scale_k and scale_v, "
                         f"and only an int8 pool takes them (pool "
                         f"{pool_k.dtype}, scales given: "
                         f"{scale_k is not None}/{scale_v is not None})")
    if quant:
        want = (pool_k.shape[0], pool_k.shape[2])
        for t in (scale_k, scale_v):
            if t.dtype != torch.float32 or tuple(t.shape) != want:
                raise ValueError(f"{name}: scales must be float32 {want}, "
                                 f"got {t.dtype} {tuple(t.shape)}")


def dequant_gather(pool: torch.Tensor, scale: Optional[torch.Tensor],
                   block: torch.Tensor) -> torch.Tensor:
    """The reference's ``layers.dequant_gather``: a batch's pages through
    the block table (B, n_pages) as (B, n_pages * page, K, D) float32,
    dequantised by the per-page scales (P, K) of an int8 pool."""
    idx = block.long()
    g = pool[idx].float()                                 # (B, npg, page, K, D)
    if scale is not None:
        g = g * scale[idx][:, :, None, :, None]
    return g.reshape(idx.shape[0], -1, *pool.shape[2:])


def _paged_plain(q: torch.Tensor, pool_k: torch.Tensor, pool_v: torch.Tensor,
                 block: torch.Tensor, valid: torch.Tensor,
                 scale_k: Optional[torch.Tensor],
                 scale_v: Optional[torch.Tensor]) -> torch.Tensor:
    """q: (B, C, H, D); valid: (B, C, S_tot) -> (B, C, H, D) in q's dtype.
    The gather through the block table is :func:`dequant_gather`."""
    _check_pool_dtypes("decode_attention_paged", pool_k, pool_v, scale_k,
                       scale_v)
    b, c, h, d = q.shape
    kh = pool_k.shape[2]
    g = _check_heads(h, kh)
    kk = dequant_gather(pool_k, scale_k, block)           # (B, S_tot, K, D)
    vv = dequant_gather(pool_v, scale_v, block)
    seen = valid.any(dim=1)[:, :, None, None]             # (B, S_tot, 1, 1)
    kk = torch.where(seen, kk, 0.0)
    vv = torch.where(seen, vv, 0.0)
    qg = q.reshape(b, c, kh, g, d).float()
    scores = torch.einsum("bckgd,bskd->bkgcs", qg, kk) * (1.0 / math.sqrt(d))
    vm = valid[:, None, None]                             # (B, 1, 1, C, S)
    scores = torch.where(vm, scores, _NEG)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(vm, torch.exp(scores - m), 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgcs,bskd->bckgd", p, vv)
    out = acc / torch.clamp(l, min=1e-30).permute(0, 3, 1, 2)[..., None]
    return out.reshape(b, c, h, d).to(q.dtype)


def decode_attention_paged_plain(q: torch.Tensor, pool_k: torch.Tensor,
                                 pool_v: torch.Tensor, block: torch.Tensor,
                                 valid: torch.Tensor,
                                 scale_k: Optional[torch.Tensor] = None,
                                 scale_v: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """q: (B, 1, H, D); pool_k/v: (P, page, K, D); block: (B, n_pages) int;
    valid: (B, n_pages * page) bool; scale_k/v: (P, K) float32 for an int8
    pool, else None.  Gathers (and dequantises) each slot's pages through
    the block table, then masked attention with float32 accumulation,
    following the Pallas kernel (q kept in float32, K/V upcast, ``acc /
    max(l, 1e-30)``).  Returns (B, 1, H, D) in q's dtype."""
    return _paged_plain(q, pool_k, pool_v, block, valid[:, None, :],
                        scale_k, scale_v)


def decode_attention_chunk_paged_plain(q: torch.Tensor, pool_k: torch.Tensor,
                                       pool_v: torch.Tensor,
                                       block: torch.Tensor,
                                       valid: torch.Tensor,
                                       scale_k: Optional[torch.Tensor] = None,
                                       scale_v: Optional[torch.Tensor] = None
                                       ) -> torch.Tensor:
    """q: (B, C, H, D); valid: (B, C, n_pages * page) bool, the positional
    and intra-chunk causal mask.  Otherwise as
    :func:`decode_attention_paged_plain`."""
    return _paged_plain(q, pool_k, pool_v, block, valid, scale_k, scale_v)


def _paged_cuda(name: str, q: torch.Tensor, pool_k: torch.Tensor,
                pool_v: torch.Tensor, block: torch.Tensor,
                valid: torch.Tensor, scale_k: Optional[torch.Tensor],
                scale_v: Optional[torch.Tensor]) -> torch.Tensor:
    """Checks and launch shared by the two paged wrappers.  q (B, C, H, D);
    valid (B, C, S_tot)."""
    _check_pool_dtypes(name, pool_k, pool_v, scale_k, scale_v)
    scales = () if scale_k is None else (scale_k, scale_v)
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{name}_cuda needs CUDA tensors, got {dev}")
    if any(t.device != dev for t in (pool_k, pool_v, block, valid, *scales)):
        raise ValueError(f"{name}: all operands must share a device")
    if valid.dtype != torch.bool:
        raise TypeError(f"{name}: valid must be bool, got {valid.dtype}")
    if q.ndim != 4 or pool_k.ndim != 4 or block.ndim != 2 or valid.ndim != 3:
        raise ValueError(f"{name}: need q (B,C,H,D), pools (P,page,K,D), "
                         "block (B,n_pages) and a mask")
    b, c, h, d = q.shape
    _, page, kh, _ = pool_k.shape
    npg = block.shape[1]
    if (pool_k.shape[3] != d or pool_v.shape != pool_k.shape
            or block.shape[0] != b or valid.shape != (b, c, npg * page)):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, pools "
                         f"{tuple(pool_k.shape)}/{tuple(pool_v.shape)}, block "
                         f"{tuple(block.shape)}, valid {tuple(valid.shape)} do "
                         "not agree")
    g = _check_heads(h, kh)
    if d not in PAGED_HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not supported by the kernel "
                         f"(need one of {PAGED_HEAD_DIMS})")
    if not all(t.is_contiguous() for t in (pool_k, pool_v, valid, *scales)):
        raise ValueError(f"{name}: pools, scales and mask must be contiguous")
    # K/V rows are staged with 16-byte loads
    if pool_k.data_ptr() % 16 or pool_v.data_ptr() % 16:
        raise ValueError(f"{name}: pools must start on a 16-byte boundary")
    if c == 1 and g > MAX_GROUP:
        raise ValueError(f"{name}: group {g} not supported by the decode "
                         f"kernel (need <= {MAX_GROUP})")
    q32 = q.float().contiguous()
    blk = block.to(torch.int32).contiguous()
    out = torch.empty((b, c, h, d), dtype=torch.float32, device=dev)
    lib = build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    # null scale pointers for float32 / bf16 pools
    sk, sv = (t.data_ptr() for t in scales) if scales else (None, None)
    common = (q32.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), sk, sv,
              blk.data_ptr(), valid.data_ptr())
    if c > 1:
        err = lib.chunk_paged_attention_launch(
            *common, out.data_ptr(), _PAGED_DTYPES[pool_k.dtype], b, c, kh,
            g, d, page, npg, 1.0 / math.sqrt(d), stream)
    else:
        split = paged_split_pages(b, kh, npg, page)
        n_split = -(-npg // split)
        ws_ptr = counters_ptr = None
        if n_split > 1:
            # each split's (acc (G, D), m (G), l (G)) in G * (D + 4) floats;
            # held until the launch, so the counters cannot take its memory
            ws = torch.empty((b * kh * n_split * g * (d + 4),),
                             dtype=torch.float32, device=dev)
            ws_ptr = ws.data_ptr()
            counters_ptr = _merge_counters(dev, stream, b * kh).data_ptr()
        err = lib.paged_attention_launch(
            *common, ws_ptr, counters_ptr, out.data_ptr(),
            _PAGED_DTYPES[pool_k.dtype], b, c, kh, g, d, page, npg, split,
            1.0 / math.sqrt(d), stream)
    build.check(err, name)
    return out.to(q.dtype)


# the paged decode kernel's merge counters, one int per (slot, kv head),
# per device and stream: the last block of each (slot, kv head) resets its
# own, so they stay 0 between calls and are allocated (zeroed) only when a
# call needs more of them.  The ones a larger call replaces are kept: a
# CUDA graph captured with them still reads them
_COUNTERS: dict = {}
_REPLACED: list = []


def _merge_counters(dev: torch.device, stream: int, n: int) -> torch.Tensor:
    key = (dev.index, stream)
    t = _COUNTERS.get(key)
    if t is None or t.numel() < n:
        if t is not None:
            _REPLACED.append(t)
        t = torch.zeros((max(n, 256),), dtype=torch.int32, device=dev)
        _COUNTERS[key] = t
    return t


def _count(fn, pool: torch.Tensor) -> None:
    if pool.dtype == torch.int8:
        fn.launches_int8 += 1
    else:
        fn.launches += 1


def decode_attention_paged_cuda(q: torch.Tensor, pool_k: torch.Tensor,
                                pool_v: torch.Tensor, block: torch.Tensor,
                                valid: torch.Tensor,
                                scale_k: Optional[torch.Tensor] = None,
                                scale_v: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """Launch the paged kernel for one query token per slot.  Shapes as
    :func:`decode_attention_paged_plain`; pools contiguous float32,
    bfloat16 or int8 (with contiguous scales) of one dtype, each on a
    16-byte boundary; D in ``PAGED_HEAD_DIMS``.
    ``decode_attention_paged_cuda.launches`` counts its launches over
    float32 and bf16 pools, ``.launches_int8`` those over int8 pools."""
    if q.ndim != 4 or q.shape[1] != 1 or valid.ndim != 2:
        raise ValueError(f"decode_attention_paged: q {tuple(q.shape)} must be "
                         "(B,1,H,D) and valid (B, S_tot)")
    out = _paged_cuda("decode_attention_paged", q, pool_k, pool_v, block,
                      valid[:, None, :], scale_k, scale_v)
    _count(decode_attention_paged_cuda, pool_k)
    return out


def decode_attention_chunk_paged_cuda(q: torch.Tensor, pool_k: torch.Tensor,
                                      pool_v: torch.Tensor,
                                      block: torch.Tensor,
                                      valid: torch.Tensor,
                                      scale_k: Optional[torch.Tensor] = None,
                                      scale_v: Optional[torch.Tensor] = None
                                      ) -> torch.Tensor:
    """Launch the paged kernel for C query tokens per slot.  Shapes as
    :func:`decode_attention_chunk_paged_plain`, requirements and counters
    as :func:`decode_attention_paged_cuda`."""
    out = _paged_cuda("decode_attention_chunk_paged", q, pool_k, pool_v,
                      block, valid, scale_k, scale_v)
    _count(decode_attention_chunk_paged_cuda, pool_k)
    return out


decode_attention_paged_cuda.launches = 0
decode_attention_paged_cuda.launches_int8 = 0
decode_attention_chunk_paged_cuda.launches = 0
decode_attention_chunk_paged_cuda.launches_int8 = 0
