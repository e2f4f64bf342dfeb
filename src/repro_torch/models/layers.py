"""Building blocks of the dense decoder (plain functions on tensors).

Conventions follow the reference's ``models/layers.py``:

* hidden states ``(B, S, D)``; attention heads ``(B, S, H, Dh)``;
* params are nested dicts of tensors; dense weights keep the reference's
  ``(in, out)`` layout and are applied as ``x @ W``;
* masks are boolean, True = attend; masked scores are ``-1e30``.

Only what the attention families (dense, MoE, VLM, the hybrid's shared
block and whisper) run is here: the contiguous-cache path and the
paged-pool path of continuous serving, with bf16 (or float32) pages or int8
pages and their per-page, per-head scales, and whisper's LayerNorm and
GELU MLP.  Large matmuls go to ``torch.matmul``; decode and chunk
attention and the copy-on-write page copies go through ``kernels/ops.py``.

Tensor parallelism.  Under an ambient mesh (``sharding/act.py``) whose
``model`` axis cuts a module, its params are this rank's shards
(``sharding/specs.shard_params``): the row-parallel products (attention's
and the MLPs' ``wo``) are all-reduced over ``model``, GELU's ``bo`` is
added once after the reduce, and :func:`lm_logits` all-gathers the
vocab-sharded logits.  Outside a mesh, or at ``model = 1``, these are the
single-device code path.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.sharding import act

Params = Dict[str, Any]
_NEG = -1e30


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Computed in float32, cast back to x's dtype."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float,
               device: torch.device | str = "cpu") -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Half-split RoPE.  x: (B, S, H, Dh); positions: (S,) shared by the
    batch, or (B, S) per row (paged slots sit at different positions)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions.float()[..., None] * freqs
    angles = angles[None, :, None, :] if positions.ndim == 1 \
        else angles[:, :, None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _qkv(params: Params, x: torch.Tensor, num_heads: int, num_kv: int,
         head_dim: int):
    b, s, _ = x.shape
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if "bq" in params:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    return (q.reshape(b, s, num_heads, head_dim),
            k.reshape(b, s, num_kv, head_dim),
            v.reshape(b, s, num_kv, head_dim))


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: Optional[torch.Tensor]) -> torch.Tensor:
    """q: (B,Sq,H,Dh)  k,v: (B,Sk,K,Dh)  GQA via head grouping.

    mask: (B|1, Sq, Sk) bool, True = attend.  As in the reference, q and the
    probabilities are rounded to the cache dtype and the products accumulate
    in float32 (bf16 products are exact in float32, so upcasting the rounded
    operands reproduces ``preferred_element_type=float32``).
    """
    b, sq, h, dh = q.shape
    kheads = k.shape[2]
    groups = h // kheads
    qg = q.reshape(b, sq, kheads, groups, dh).to(k.dtype).float()
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) / math.sqrt(dh)
    if mask is not None:
        scores = torch.where(mask[:, None, None, :, :], scores, _NEG)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype).float(),
                       v.float())
    return out.reshape(b, sq, h, dh).to(q.dtype)


def causal_window_mask(sq: int, sk: int, *, q_offset: int = 0,
                       window: Optional[int] = None,
                       device: torch.device | str = "cpu") -> torch.Tensor:
    """(1, Sq, Sk) boolean mask: causal, optionally sliding-window."""
    qpos = torch.arange(sq, device=device)[:, None] + q_offset
    kpos = torch.arange(sk, device=device)[None, :]
    mask = kpos <= qpos
    if window is not None:
        mask = mask & (qpos - kpos < window)
    return mask[None]


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      q_chunk: int, causal: bool,
                      window: Optional[int] = None) -> torch.Tensor:
    """Query-chunked attention: bounds the score buffer to (B,H,qc,Sk).
    Each query block sees its complete key row, so plain softmax is exact."""
    sq = q.shape[1]
    if sq % q_chunk:
        raise ValueError(f"seq {sq} not divisible by q_chunk {q_chunk}")
    outs = []
    for i in range(sq // q_chunk):
        mask = None
        if causal:
            mask = causal_window_mask(q_chunk, k.shape[1],
                                      q_offset=i * q_chunk, window=window,
                                      device=q.device)
        outs.append(_sdpa(q[:, i * q_chunk:(i + 1) * q_chunk], k, v, mask))
    return torch.cat(outs, dim=1)


def attention_forward(params: Params, x: torch.Tensor, *, num_heads: int,
                      num_kv: int, head_dim: int, rope_theta: float,
                      causal: bool = True, window: Optional[int] = None,
                      q_chunk: int = 512) -> torch.Tensor:
    """Full-sequence self-attention (the forward pass; K/V not rounded)."""
    b, s, _ = x.shape
    q, k, v = _qkv(params, x, num_heads, num_kv, head_dim)
    if rope_theta > 0:
        pos = torch.arange(s, device=x.device)
        q = apply_rope(q, pos, rope_theta)
        k = apply_rope(k, pos, rope_theta)
    if s > q_chunk and s % q_chunk == 0:
        out = chunked_attention(q, k, v, q_chunk=q_chunk, causal=causal,
                                window=window)
    else:
        mask = (causal_window_mask(s, s, window=window, device=x.device)
                if causal else None)
        out = _sdpa(q, k, v, mask)
    return act.reduce_model(
        out.reshape(b, s, num_heads * head_dim) @ params["wo"], "attn")


def decode_valid(seq: int, pos: int, window: Optional[int],
                 device: torch.device | str) -> torch.Tensor:
    """(S,) bool validity of the cache rows for a query at ``pos``."""
    kpos = torch.arange(seq, device=device)
    valid = kpos <= pos
    if window is not None:
        valid = valid & (pos - kpos < window)
    return valid


def ring_positions(pos: int, w: int, device) -> torch.Tensor:
    """(W,) the position each slot of a W-slot ring holds after position
    ``pos`` was written: position p lives in slot p % W, so slot s holds
    ``pos - ((pos - s) mod W)``, negative where nothing was written yet."""
    return pos - torch.remainder(pos - torch.arange(w, device=device), w)


def attention_decode(params: Params, x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos: int, *, num_heads: int,
                     num_kv: int, head_dim: int, rope_theta: float,
                     window: Optional[int] = None,
                     ring: bool = False) -> torch.Tensor:
    """One-token decode.  x: (B, 1, D); cache_k/v: (B, S, K, Dh) views of
    one layer; pos: the host-side position (every row decodes at the same
    depth in the drained batch, so it is a python int, not a device value).

    Writes the new K/V into row ``pos`` of the caches IN PLACE (the
    reference's ``dynamic_update_slice``) and returns out (B, 1, D).
    ``ring``: the caches are an S-slot ring of a sliding-window layer
    (``transformer.decode_step_split``): the row is ``pos % S`` and every
    slot written so far is visible (RoPE is applied at the absolute
    position before the write, so reads need no fix-up)."""
    b = x.shape[0]
    q, k, v = _qkv(params, x, num_heads, num_kv, head_dim)
    if rope_theta > 0:
        p1 = torch.full((1,), pos, dtype=torch.int64, device=x.device)
        q = apply_rope(q, p1, rope_theta)
        k = apply_rope(k, p1, rope_theta)
    seq = cache_k.shape[1]
    row = pos % seq if ring else pos
    cache_k[:, row] = k[:, 0].to(cache_k.dtype)
    cache_v[:, row] = v[:, 0].to(cache_v.dtype)
    valid = (ring_positions(pos, seq, x.device) >= 0 if ring
             else decode_valid(seq, pos, window, x.device))
    out = ops.decode_attention(q, cache_k, cache_v, valid)
    return act.reduce_model(
        out.reshape(b, 1, num_heads * head_dim) @ params["wo"], "attn")


# ---------------------------------------------------------------------------
# paged KV pool (continuous batching)
# ---------------------------------------------------------------------------
#
# One physical pool per layer, (P, page, K, Dh), shared by every decode slot
# through an int32 block table (slot, logical page) -> physical page.  Page 0
# is the null page: idle slots and unallocated logical pages point there, it
# receives the benign raced writes of idle slots, and no positional mask ever
# exposes it.  The pools are updated IN PLACE (the reference donates them);
# where the reference relies on reading before writing, the order of the
# calls below keeps it.  The reference's page gather (``dequant_gather``)
# and its plain COW (``cow_copy_pages`` / ``cow_copy_scales``) live beside
# their kernels, as the plain versions in ``kernels/decode_attention.py``
# and ``kernels/copy_pages.py``.


def _positional_valid(positions: torch.Tensor, s_tot: int,
                      window: Optional[int]) -> torch.Tensor:
    """(..., S_tot) bool: key position s is visible from query position p iff
    s <= p and, with a window, p - s < window."""
    kpos = torch.arange(s_tot, device=positions.device)
    p = positions[..., None]
    valid = kpos <= p
    if window is not None:
        valid = valid & (p - kpos < window)
    return valid


def _append(pool_k: torch.Tensor, pool_v: torch.Tensor,
            scale_k: Optional[torch.Tensor], scale_v: Optional[torch.Tensor],
            pg: torch.Tensor, off: torch.Tensor, k: torch.Tensor,
            v: torch.Tensor) -> None:
    """Write tokens' K/V (..., K, Dh) at (pg, off) IN PLACE: rounded to the
    pool dtype, or, with scales, quantised by :func:`quant_append_page`.
    Several writes to the null page race benignly: no mask exposes it."""
    if scale_k is None:
        pool_k[pg, off] = k.to(pool_k.dtype)
        pool_v[pg, off] = v.to(pool_v.dtype)
        return
    quant_append_page(pool_k, scale_k, pg, off, k)
    quant_append_page(pool_v, scale_v, pg, off, v)


def attention_decode_paged(params: Params, x: torch.Tensor,
                           pool_k: torch.Tensor, pool_v: torch.Tensor,
                           block: torch.Tensor, pos: torch.Tensor, *,
                           num_heads: int, num_kv: int, head_dim: int,
                           rope_theta: float, window: Optional[int] = None,
                           write_block: Optional[torch.Tensor] = None,
                           scale_k: Optional[torch.Tensor] = None,
                           scale_v: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """One-token decode against a paged KV pool (one layer's slice of it).

    x: (B, 1, D); pool_k/v: (P, page, K, Dh); block: (B, n_pages) int32;
    pos: (B,) per-slot positions.  The new token's K/V go IN PLACE into page
    ``write_block[b, pos_b // page]`` at offset ``pos_b % page``
    (``write_block`` defaults to ``block``; with prefix sharing it masks
    shared, read-only pages to the null page).  Reads walk each slot's pages
    through ``block`` under the positional mask.  ``scale_k/v`` (P, K)
    float32 mark the pools int8: the append quantises through the page's
    running-max scale (updated in place) and the read dequantises inside
    the gather.  Returns out (B, 1, D)."""
    b = x.shape[0]
    page = pool_k.shape[1]
    n_pages = block.shape[1]
    q, k, v = _qkv(params, x, num_heads, num_kv, head_dim)
    if rope_theta > 0:
        pq = pos[:, None]
        q = apply_rope(q, pq, rope_theta)
        k = apply_rope(k, pq, rope_theta)
    wb = block if write_block is None else write_block
    rows = torch.arange(b, device=x.device)
    # the reference's gather clamps an out-of-range logical page; so does this
    logical = torch.clamp(pos // page, max=n_pages - 1).long()
    pg = wb[rows, logical].long()
    off = (pos % page).long()
    _append(pool_k, pool_v, scale_k, scale_v, pg, off, k[:, 0], v[:, 0])
    valid = _positional_valid(pos, n_pages * page, window)
    out = ops.decode_attention_paged(q, pool_k, pool_v, block, valid,
                                     scale_k, scale_v)
    return act.reduce_model(
        out.reshape(b, 1, num_heads * head_dim) @ params["wo"], "attn")


def attention_chunk_paged(params: Params, x: torch.Tensor,
                          pool_k: torch.Tensor, pool_v: torch.Tensor,
                          block: torch.Tensor, pos: torch.Tensor, *,
                          num_heads: int, num_kv: int, head_dim: int,
                          rope_theta: float, window: Optional[int] = None,
                          write_block: Optional[torch.Tensor] = None,
                          scale_k: Optional[torch.Tensor] = None,
                          scale_v: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """C tokens per slot at per-slot start positions: token i of slot b sits
    at ``pos[b] + i``.  All C tokens' K/V are written IN PLACE first (through
    ``write_block``; positions past the slot's page row go to the null
    page), then every query reads the slot's pages under the mask
    ``s <= pos[b] + i``, which carries the intra-chunk causal structure.
    With ``scale_k/v`` (int8 pools) the whole chunk is committed at each
    page's final running-max scale, one rounding, where C decode steps may
    requantise: chunk and steps then agree to a tolerance, not bitwise.
    x: (B, C, D); returns out (B, C, D)."""
    b, c, _ = x.shape
    page = pool_k.shape[1]
    n_pages = block.shape[1]
    q, k, v = _qkv(params, x, num_heads, num_kv, head_dim)
    positions = pos[:, None] + torch.arange(c, device=x.device)[None, :]
    if rope_theta > 0:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    wb = block if write_block is None else write_block
    logical = positions // page
    in_range = logical < n_pages
    rows = torch.arange(b, device=x.device)[:, None]
    pg = torch.where(in_range,
                     wb[rows, torch.clamp(logical, max=n_pages - 1).long()],
                     0).long()
    off = (positions % page).long()
    _append(pool_k, pool_v, scale_k, scale_v, pg, off, k, v)
    valid = _positional_valid(positions, n_pages * page, window)
    out = ops.decode_attention_chunk_paged(q, pool_k, pool_v, block, valid,
                                           scale_k, scale_v)
    return act.reduce_model(
        out.reshape(b, c, num_heads * head_dim) @ params["wo"], "attn")


def scatter_prefill_pages(pool: torch.Tensor, seq_kv: torch.Tensor,
                          block_rows: torch.Tensor) -> None:
    """Write a batch of sequences' prefill K (or V) into their pages, IN
    PLACE.  pool: (P, page, K, Dh); seq_kv: (A, S, K, Dh), S % page == 0;
    only the first S // page entries of each block row are written.  Rows of
    padded admissions and redirected prefix pages point at the null page,
    where their raced writes land harmlessly."""
    page = pool.shape[1]
    a, s = seq_kv.shape[:2]
    paged = seq_kv.reshape(a, s // page, page, *seq_kv.shape[2:])
    pool[block_rows[:, : s // page].long()] = paged.to(pool.dtype)


def suffix_write_rows(block_rows: torch.Tensor, start: torch.Tensor,
                      n_pages: int, page: int) -> torch.Tensor:
    """Mask block rows down to the uncached suffix: pages below
    ``start // page`` belong to the shared, read-only prefix, so their
    prefill re-writes are redirected to the null page."""
    page_idx = torch.arange(n_pages, device=block_rows.device)[None, :]
    return torch.where(page_idx < (start // page)[:, None], 0,
                       block_rows[:, :n_pages])


def substitute_prefix_kv(pool: torch.Tensor, inpass: torch.Tensor,
                         block_rows: torch.Tensor, start: torch.Tensor,
                         scale: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Splice cached prefix K (or V) under the in-pass suffix values.

    pool: (P, page, K, Dh); inpass: (A, S, K, Dh); block_rows: (A, n_pages);
    start: (A,).  Positions < start read the slot's aliased pages (the values
    the row's own full prefill would have produced); positions >= start keep
    the in-pass values.  ``scale`` (P, K) marks the pool int8: cached pages
    dequantise through their scales (``inpass`` is then fake-quantised on
    the same grid, :func:`quant_dequant_pages`).  Must run before this
    layer's page writes."""
    a, s = inpass.shape[:2]
    page = pool.shape[1]
    rows = block_rows[:, : s // page].long()
    cached = pool[rows]
    if scale is not None:
        cached = cached.float() * scale[rows][:, :, None, :, None]
    cached = cached.reshape(a, s, *inpass.shape[2:])
    pos = torch.arange(s, device=inpass.device)[None, :, None, None]
    return torch.where(pos < start[:, None, None, None],
                       cached.to(inpass.dtype), inpass)


# ---------------------------------------------------------------------------
# int8 page quantisation (per-page, per-head symmetric scales)
# ---------------------------------------------------------------------------
#
# An int8 pool (P, page, K, Dh) carries a (P, K) float32 scale tensor: one
# symmetric scale per physical page and kv head, dequantised value = int8 *
# scale.  The reference's write contract, kept here with in-place updates:
#   * prefill overwrites whole pages, so its scale rows are SET
#     (:func:`quant_scatter_prefill_pages`): a recycled page's stale scale
#     never survives;
#   * decode and chunk appends grow a page token by token, so its scale is
#     a monotone running max (:func:`quant_append_page`); growing it
#     requantises the page's content to the new grid (ratio <= 1, one more
#     rounding), and a token at page offset 0 first resets the recycled
#     page's scale.
# Scale rows are indexed by physical page like the pages, so copy-on-write
# moves them with their pages (``model_zoo.cow_pages``).  Rounding is
# ``torch.round`` (half to even, as ``jnp.round``) and every division is in
# float32, as in the reference.

_QMAX = 127.0


def _safe_scale(s: torch.Tensor) -> torch.Tensor:
    return torch.clamp(s, min=1e-30)


def quant_append_page(pool: torch.Tensor, scale: torch.Tensor,
                      pg: torch.Tensor, off: torch.Tensor,
                      val: torch.Tensor) -> None:
    """Append tokens' K (or V) into an int8 pool at (pg, off), IN PLACE,
    under a monotone per-page, per-head running-max scale.

    pool: (P, page, K, Dh) int8; scale: (P, K) float32; pg/off: (...,) long
    (token -> physical page, offset in it); val: (..., K, Dh).  One chunk
    may write a page several times: the running max reduces over every
    duplicate, and each duplicate then repacks the page's old content to
    identical bytes, so the duplicates' writes agree.  Each read below
    happens before the write that follows it, as in the reference's
    functional version."""
    kh = scale.shape[1]
    pg, off = pg.reshape(-1), off.reshape(-1)
    v32 = val.float().reshape(-1, kh, val.shape[-1])
    absmax = v32.abs().amax(dim=-1)                           # (n, K)
    # offset 0 is the first write into a freshly allocated page: reset the
    # recycled page's stale scale (off != 0 tokens re-zero the null page,
    # which nothing dequantises)
    scale[torch.where(off == 0, pg, 0)] = 0.0
    old = scale[pg]                                           # (n, K)
    scale.scatter_reduce_(0, pg[:, None].expand(-1, kh), absmax / _QMAX,
                          reduce="amax", include_self=True)
    new = scale[pg]
    ratio = torch.clamp(_safe_scale(old) / _safe_scale(new), 0.0, 1.0)
    repack = torch.round(pool[pg].float() * ratio[:, None, :, None])
    pool[pg] = repack.to(pool.dtype)
    q = torch.clamp(torch.round(v32 / _safe_scale(new)[..., None]),
                    -_QMAX, _QMAX)
    pool[pg, off] = q.to(pool.dtype)


def quant_dequant_pages(kv: torch.Tensor, page: int) -> torch.Tensor:
    """Fake-quantise full-sequence K/V through the int8 per-page, per-head
    grid: exactly the values a later paged read dequantises to
    (:func:`quant_scatter_prefill_pages` recomputes the same scales from
    the same raw values).  kv: (A, S, K, Dh), S % page == 0."""
    a, s = kv.shape[:2]
    paged = kv.float().reshape(a, s // page, page, *kv.shape[2:])
    sc = paged.abs().amax(dim=(2, 4), keepdim=True) / _QMAX
    q = torch.clamp(torch.round(paged / _safe_scale(sc)), -_QMAX, _QMAX)
    return (q * sc).reshape(kv.shape).to(kv.dtype)


def quant_scatter_prefill_pages(pool: torch.Tensor, scale: torch.Tensor,
                                seq_kv: torch.Tensor,
                                block_rows: torch.Tensor) -> None:
    """:func:`scatter_prefill_pages` into an int8 pool, IN PLACE: whole
    pages quantised with freshly computed per-page, per-head scales, which
    are SET (prefill owns the page).  ``seq_kv`` holds the raw values; rows
    redirected to the null page drop their page and scale there."""
    page = pool.shape[1]
    a, s = seq_kv.shape[:2]
    paged = seq_kv.float().reshape(a, s // page, page, *seq_kv.shape[2:])
    rows = block_rows[:, : s // page].long()
    sc = paged.abs().amax(dim=(2, 4)) / _QMAX                 # (A, npg, K)
    q = torch.clamp(torch.round(paged / _safe_scale(sc)[:, :, None, :, None]),
                    -_QMAX, _QMAX)
    pool[rows] = q.to(pool.dtype)
    scale[rows] = sc


def swiglu(params: Params, x: torch.Tensor, kind: str = "mlp"
           ) -> torch.Tensor:
    """``kind`` names the module for the tensor-parallel reduce: "mlp",
    or the MoE layer's "shared" experts and "dense" residual."""
    return act.reduce_model(
        (F.silu(x @ params["wg"]) * (x @ params["wi"])) @ params["wo"], kind)


def lm_logits(h: torch.Tensor, lm_head: torch.Tensor) -> torch.Tensor:
    """``h @ lm_head`` as float32 logits, whole vocab rows under a mesh
    that cuts the lm_head."""
    return act.gather_vocab(h @ lm_head).float()


# ---------------------------------------------------------------------------
# the enc-dec family's pieces (whisper): LayerNorm and the GELU MLP
# ---------------------------------------------------------------------------

def layernorm(params: Params, x: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """Computed in float32 (biased variance, as ``jnp.var``), cast back to
    x's dtype."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


def gelu_mlp(params: Params, x: torch.Tensor) -> torch.Tensor:
    """GELU in its tanh form, ``jax.nn.gelu``'s default."""
    return act.reduce_model(
        F.gelu(x @ params["wi"] + params["bi"], approximate="tanh")
        @ params["wo"], "mlp") + params["bo"]
