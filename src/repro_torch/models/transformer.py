"""Dense decoder-only transformer (qwen2 / gemma3 / granite / danube, and
llava's LM) on a contiguous KV cache and on the paged KV pool of continuous
serving.

The reference scans one layer body over ``(L, ...)``-stacked params; here a
python loop walks the same stacked params layer by layer.  Per-layer
heterogeneity (gemma3's 5:1 local:global attention) is a per-layer window
size, as in the reference.  The serving functions take the layer's FFN as
``ffn(lp, cfg, x)`` (default: the dense SwiGLU), so the MoE family runs the
same attention and page code with its routed FFN (``models/moe.py``).

The cache dict holds ``k``/``v`` of shape (L, B, S, K, Dh) and ``pos``, the
number of filled rows, kept as a python int: in the drained batch every row
decodes at the same depth, so the position is known on the host and no
device value is ever read back to pick the write row.

The paged pool holds ``kp``/``vp`` of shape (L, P, page, K, Dh): one
physical allocation per tier shared by every decode slot through an int32
block table (see ``layers.attention_decode_paged``).  An int8 pool also
holds ``ks``/``vs``, (L, P, K) float32 scales, one per physical page and kv
head.  It is updated in place, where the reference donates it.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.sharding import act

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _normal(gen: torch.Generator, shape, std: float) -> torch.Tensor:
    """Scaled in place: one copy of the tensor at a time (a stacked expert
    weight of deepseek-moe-16b is 20.7 GB in float32).  A generator on the
    ``meta`` device (``model_zoo.init_params_spec``) gives shapes only."""
    if gen.device.type == "meta":
        return torch.empty(shape, device="meta")
    return torch.randn(shape, generator=gen, device=gen.device).mul_(std)


def _dense(gen, shape) -> torch.Tensor:
    """A stacked (..., in, out) weight with the reference's 1/sqrt(in) scale."""
    return _normal(gen, shape, 1.0 / math.sqrt(shape[-2]))


def attention_params(gen: torch.Generator, cfg: ModelConfig, n: int,
                     d: int) -> Params:
    """``n`` stacked attention blocks of width ``d`` (biases zero)."""
    hd = cfg.resolved_head_dim
    hq, hk = cfg.num_heads * hd, cfg.num_kv_heads * hd
    dev = gen.device
    attn = {"wq": _dense(gen, (n, d, hq)),
            "wk": _dense(gen, (n, d, hk)),
            "wv": _dense(gen, (n, d, hk)),
            "wo": _dense(gen, (n, hq, d))}
    if cfg.qkv_bias:
        attn.update(bq=torch.zeros(n, hq, device=dev),
                    bk=torch.zeros(n, hk, device=dev),
                    bv=torch.zeros(n, hk, device=dev))
    return attn


def swiglu_params(gen: torch.Generator, lead, d: int, ff: int) -> Params:
    """SwiGLU weights stacked over the ``lead`` axes."""
    lead = tuple(lead)
    return {"wi": _dense(gen, lead + (d, ff)),
            "wg": _dense(gen, lead + (d, ff)),
            "wo": _dense(gen, lead + (ff, d))}


def init_decoder(gen: torch.Generator, cfg: ModelConfig,
                 ffn_params=None) -> Params:
    """Random float32 params with the reference's shapes, layout and
    scales, on the generator's device.  (The numbers differ from the
    reference's: torch's generator is not jax's.  Parity tests bridge the
    reference's params.)  ``ffn_params(gen)`` makes the layers' FFN
    entries (default: the dense ``"mlp"``)."""
    n, d = cfg.num_layers, cfg.d_model
    dev = gen.device
    layers = {"ln1": {"scale": torch.ones(n, d, device=dev)},
              "attn": attention_params(gen, cfg, n, d),
              "ln2": {"scale": torch.ones(n, d, device=dev)}}
    layers.update(ffn_params(gen) if ffn_params is not None else
                  {"mlp": swiglu_params(gen, (n,), d, cfg.d_ff)})
    return {"embed": _normal(gen, (cfg.vocab_size, d), 0.02),
            "layers": layers,
            "final_norm": {"scale": torch.ones(d, device=dev)},
            "lm_head": _dense(gen, (d, cfg.vocab_size))}


def dense_ffn(lp: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The dense family's FFN: the layer's SwiGLU."""
    return L.swiglu(lp["mlp"], x)


FFN = Callable[[Params, ModelConfig, torch.Tensor], torch.Tensor]


def layer_params(layers: Params, i: int) -> Params:
    """Layer ``i`` of the stacked layer params (views, no copy)."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in layers.items()}


def maybe_remat(fn: Callable, remat: bool) -> Callable:
    """``fn`` under activation checkpointing where ``remat`` (the
    reference's ``jax.checkpoint`` of a layer's body): its activations are
    recomputed in the backward pass instead of kept."""
    if not remat:
        return fn
    return functools.partial(torch.utils.checkpoint.checkpoint, fn,
                             use_reentrant=False)


def layer_windows(cfg: ModelConfig,
                  seq_len: Optional[int]) -> List[Optional[int]]:
    """Per-layer sliding-window sizes; ``seq_len`` means full causal."""
    if cfg.local_global_ratio:
        period = cfg.local_global_ratio + 1
        return [seq_len if i % period == cfg.local_global_ratio
                else cfg.sliding_window for i in range(cfg.num_layers)]
    if cfg.sliding_window:
        return [cfg.sliding_window] * cfg.num_layers
    return [seq_len] * cfg.num_layers


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _layer(lp: Params, cfg: ModelConfig, h: torch.Tensor,
           win: int) -> torch.Tensor:
    h = h + L.attention_forward(
        lp["attn"], L.rmsnorm(lp["ln1"], h, cfg.norm_eps),
        num_heads=cfg.num_heads, num_kv=cfg.num_kv_heads,
        head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
        window=win)
    return h + dense_ffn(lp, cfg, L.rmsnorm(lp["ln2"], h, cfg.norm_eps))


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            patch_embeds: Optional[torch.Tensor] = None,
            remat: bool = False, last_only: bool = False) -> torch.Tensor:
    """tokens: (B, S) -> logits (B, S_total, V) float32.

    For VLM configs, ``patch_embeds`` (B, P, D) is prepended to the token
    embeddings (the stubbed vision tower's output): S_total = P + S.
    ``remat`` checkpoints each layer.  ``last_only`` keeps the last
    position before the vocab projection (the prefill serving path):
    logits (B, 1, V)."""
    h = params["embed"][tokens]
    if patch_embeds is not None:
        h = torch.cat([patch_embeds.to(h.dtype), h], dim=1)
    layer = maybe_remat(_layer, remat)
    for i, win in enumerate(layer_windows(cfg, h.shape[1])):
        h = layer(layer_params(params["layers"], i), cfg, h, win)
    h = L.rmsnorm(params["final_norm"], h, cfg.norm_eps)
    if last_only:
        h = h[:, -1:]
    return L.lm_logits(h, params["lm_head"])


# ---------------------------------------------------------------------------
# contiguous KV cache: prefill + decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               dtype=torch.bfloat16, device="cuda") -> Params:
    shape = (cfg.num_layers, batch, seq_len, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": 0}


def _prefill_layer(lp: Params, cfg: ModelConfig, h: torch.Tensor,
                   win: int, kv_dtype, pos: torch.Tensor,
                   splice=None, page: int = 0,
                   ffn: FFN = dense_ffn) -> Tuple[torch.Tensor, torch.Tensor,
                                                  torch.Tensor]:
    """One layer of the batched prefill shared by :func:`prefill` and
    :func:`prefill_paged` (the reference's ``_prefill_body``).  K/V are
    rounded to the cache dtype before the in-pass attention, so logits and
    cache match the token-by-token decode path; sequences longer than 512
    that divide into 512-query chunks take the chunked attention.

    ``kv_dtype`` int8 (a page pool of ``page`` positions): the in-pass
    attention sees K/V fake-quantised on the per-page int8 grid
    (``layers.quant_dequant_pages``, exactly what later paged reads
    dequantise to), and the raw values are returned for the caller's
    ``quant_scatter_prefill_pages``, which recomputes the same scales.

    ``splice`` = (pool_k, pool_v, scale_k, scale_v, block_rows, start) of
    this layer (prefix sharing; scales None but for int8): positions below
    ``start`` take the cached prefix K/V from the aliased pages, read
    before this layer's page writes.
    Returns (h, k, v) with k/v (B, S, K, Dh) in the cache dtype, raw for
    int8."""
    b, s, _ = h.shape
    hd = cfg.resolved_head_dim
    q, k, v = L._qkv(lp["attn"], L.rmsnorm(lp["ln1"], h, cfg.norm_eps),
                     cfg.num_heads, cfg.num_kv_heads, hd)
    if cfg.rope_theta > 0:
        q = L.apply_rope(q, pos, cfg.rope_theta)
        k = L.apply_rope(k, pos, cfg.rope_theta)
    if kv_dtype == torch.int8:
        k_raw, v_raw = k, v
        k, v = L.quant_dequant_pages(k, page), L.quant_dequant_pages(v, page)
    else:
        k, v = k.to(kv_dtype), v.to(kv_dtype)
    if splice is not None:
        pk, pv, sk, sv, block_rows, start = splice
        k = L.substitute_prefix_kv(pk, k, block_rows, start, sk)
        v = L.substitute_prefix_kv(pv, v, block_rows, start, sv)
    if s > 512 and s % 512 == 0:
        a = L.chunked_attention(q, k, v, q_chunk=512, causal=True, window=win)
    else:
        a = L._sdpa(q, k, v, L.causal_window_mask(s, s, window=win,
                                                  device=h.device))
    h = h + act.reduce_model(
        a.reshape(b, s, cfg.num_heads * hd) @ lp["attn"]["wo"], "attn")
    h = h + ffn(lp, cfg, L.rmsnorm(lp["ln2"], h, cfg.norm_eps))
    if kv_dtype == torch.int8:
        return h, k_raw, v_raw
    return h, k, v


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            cache: Params, *, ffn: FFN = dense_ffn
            ) -> Tuple[torch.Tensor, Params]:
    """Fill the KV cache from a (B, S) prompt in one batched pass.

    The prompt's K/V are written into rows [0, S) of ``cache`` IN PLACE (the
    reference's ``dynamic_update_slice``); rows past S are never read.

    Returns (logits of the last position (B, V) float32, cache).  The last
    position is ``S - 1`` for every row, right padding included: that is
    the reference's semantics.
    """
    h = params["embed"][tokens]
    s = h.shape[1]
    kv_dtype = cache["k"].dtype
    pos = torch.arange(s, device=h.device)
    for i, win in enumerate(layer_windows(cfg, s)):
        h, k, v = _prefill_layer(layer_params(params["layers"], i), cfg, h,
                                 win, kv_dtype, pos, ffn=ffn)
        cache["k"][i, :, :s] = k
        cache["v"][i, :, :s] = v
    h = L.rmsnorm(params["final_norm"], h, cfg.norm_eps)
    logits = L.lm_logits(h[:, -1, :], params["lm_head"])
    return logits, {"k": cache["k"], "v": cache["v"], "pos": s}


def _uniform_kv(cfg: ModelConfig, cache: Params) -> List[Tuple]:
    """(k, v, window, ring) per layer of a uniform cache."""
    seq = cache["k"].shape[2]
    return [(cache["k"][i], cache["v"][i], win, False)
            for i, win in enumerate(layer_windows(cfg, seq))]


def decode_step(params: Params, cfg: ModelConfig, token: torch.Tensor,
                cache: Params, *, ffn: FFN = dense_ffn,
                layer_kv: Callable = _uniform_kv
                ) -> Tuple[torch.Tensor, Params]:
    """token: (B, 1) -> (logits (B, V) float32, cache advanced by one row).
    The new K/V rows are written into ``cache`` in place.  ``layer_kv``
    gives each layer's (k, v, window, ring) views of the cache."""
    h = params["embed"][token]
    pos = cache["pos"]
    for i, (ck, cv, win, ring) in enumerate(layer_kv(cfg, cache)):
        lp = layer_params(params["layers"], i)
        h = h + L.attention_decode(
            lp["attn"], L.rmsnorm(lp["ln1"], h, cfg.norm_eps), ck, cv, pos,
            num_heads=cfg.num_heads, num_kv=cfg.num_kv_heads,
            head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
            window=win, ring=ring)
        h = h + ffn(lp, cfg, L.rmsnorm(lp["ln2"], h, cfg.norm_eps))
    h = L.rmsnorm(params["final_norm"], h, cfg.norm_eps)
    logits = L.lm_logits(h[:, 0, :], params["lm_head"])
    return logits, dict(cache, pos=pos + 1)


# ---------------------------------------------------------------------------
# split-cache decode: ring buffers for sliding-window layers
# ---------------------------------------------------------------------------
#
# The uniform cache allocates the full sequence for every layer, but a local
# (sliding-window) layer only ever reads the last W positions.  For gemma3's
# 5:1 pattern at 500k that wastes ~80% of the cache's memory.  The split
# cache keeps an (n_local, B, W, K, Dh) ring for the local layers and full
# (n_global, B, S, K, Dh) stacks for the global ones only.  Position p of a
# local layer lives in ring slot p % W (``layers.ring_positions``).

def _is_local(cfg: ModelConfig) -> List[bool]:
    """Which layers are sliding-window layers: those with a window at any
    length (:func:`layer_windows` with no length)."""
    return [win is not None for win in layer_windows(cfg, None)]


def num_local_layers(cfg: ModelConfig) -> int:
    """The count of sliding-window layers."""
    return sum(_is_local(cfg))


def init_split_cache(cfg: ModelConfig, batch: int, seq_len: int,
                     dtype=torch.bfloat16, device="cuda") -> Params:
    """Zeroed ``local_k``/``local_v`` rings (n_local, B, W, K, Dh) and
    ``global_k``/``global_v`` stacks (n_global, B, S, K, Dh) (zero-size
    where every layer is local), ``pos`` a host int."""
    n_local = num_local_layers(cfg)
    n_global = cfg.num_layers - n_local
    tail = (cfg.num_kv_heads, cfg.resolved_head_dim)
    local = (n_local, batch, cfg.sliding_window) + tail
    glob = (n_global, batch, seq_len) + tail
    return {"local_k": torch.zeros(local, dtype=dtype, device=device),
            "local_v": torch.zeros(local, dtype=dtype, device=device),
            "global_k": torch.zeros(glob, dtype=dtype, device=device),
            "global_v": torch.zeros(glob, dtype=dtype, device=device),
            "pos": 0}


def split_cache_spec(cfg: ModelConfig, batch: int, seq_len: int,
                     dtype=torch.bfloat16) -> Params:
    """:func:`init_split_cache`'s tree on the ``meta`` device."""
    return init_split_cache(cfg, batch, seq_len, dtype, "meta")


def _split_kv(cfg: ModelConfig, cache: Params) -> List[Tuple]:
    """(k, v, window, ring) per layer of a split cache: local layers read
    their ring, global ones their stack (full causal)."""
    taken = {True: 0, False: 0}
    out = []
    for local in _is_local(cfg):
        kind, j = ("local" if local else "global"), taken[local]
        taken[local] += 1
        out.append((cache[f"{kind}_k"][j], cache[f"{kind}_v"][j], None,
                    local))
    return out


def decode_step_split(params: Params, cfg: ModelConfig, token: torch.Tensor,
                      cache: Params) -> Tuple[torch.Tensor, Params]:
    """:func:`decode_step` over a split cache (``sliding_window`` > 0): the
    new K/V rows are written in place (local layers at ring slot
    ``pos % W``), and every layer's attention is ``ops.decode_attention``,
    over the ring with the slots written so far visible, or over the
    global stack up to ``pos``."""
    if not cfg.sliding_window:
        raise ValueError("split cache needs a sliding-window arch")
    return decode_step(params, cfg, token, cache, layer_kv=_split_kv)


# ---------------------------------------------------------------------------
# paged KV pool (continuous batching)
# ---------------------------------------------------------------------------

def paged_kv(lead: int, num_pages: int, page_size: int, kv_heads: int,
             head_dim: int, dtype, device) -> Params:
    """Zeroed (lead, P, page, K, Dh) ``kp``/``vp`` pools of ``dtype``
    (bfloat16, float32 or int8) and, for int8, the (lead, P, K) float32
    ``ks``/``vs`` scale rows (dequantised value = int8 * scale)."""
    if dtype not in (torch.bfloat16, torch.float32, torch.int8):
        raise ValueError(f"paged pool dtype {dtype}: need bfloat16, float32 "
                         "or int8")
    shape = (lead, num_pages, page_size, kv_heads, head_dim)
    cache = {"kp": torch.zeros(shape, dtype=dtype, device=device),
             "vp": torch.zeros(shape, dtype=dtype, device=device)}
    if dtype == torch.int8:
        sshape = (lead, num_pages, kv_heads)
        cache["ks"] = torch.zeros(sshape, dtype=torch.float32, device=device)
        cache["vs"] = torch.zeros(sshape, dtype=torch.float32, device=device)
    return cache


def page_tensors(cache: Params) -> Tuple[torch.Tensor, ...]:
    """The tensors indexed by physical page (axis 1): the ``kp``/``vp``
    pools and, for int8, their ``ks``/``vs`` scale rows after them.  A page
    that moves (copy-on-write) moves its row of each."""
    return tuple(cache[k] for k in ("kp", "vp", "ks", "vs") if k in cache)


def scales(cache: Params, i: int) -> Dict[str, Any]:
    """Layer (or group) ``i``'s scale rows as ``scale_k``/``scale_v``
    keywords: None for a float32 or bf16 pool."""
    if "ks" not in cache:
        return {"scale_k": None, "scale_v": None}
    return {"scale_k": cache["ks"][i], "scale_v": cache["vs"][i]}


def init_paged_cache(cfg: ModelConfig, num_slots: int, num_pages: int,
                     page_size: int, dtype=torch.bfloat16,
                     device="cuda") -> Params:
    """Zeroed (L, P, page, K, Dh) K and V pools (and int8 pools' scale
    rows).  Attention state lives in pages only, so ``num_slots`` does not
    size anything."""
    del num_slots
    return paged_kv(cfg.num_layers, num_pages, page_size, cfg.num_kv_heads,
                    cfg.resolved_head_dim, dtype, device)


def prefill_paged(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  lengths: torch.Tensor, slots: torch.Tensor,
                  block_rows: torch.Tensor, cache: Params, *,
                  start: Optional[torch.Tensor] = None, ffn: FFN = dense_ffn
                  ) -> Tuple[torch.Tensor, Params]:
    """Prefill a batch of admitted requests into their pages in one pass.

    tokens: (A, S_max) right-padded; lengths: (A,) bucketed prompt lengths
    (each row's logits are taken at ``lengths[i] - 1``); block_rows:
    (A, n_pages) the admitted slots' block rows, null-page rows for padded
    admissions.  ``start`` (prefix sharing): per-row first uncached
    position; cached positions' K/V are spliced from the aliased pages and
    their page writes go to the null page.  Layer math is :func:`prefill`'s;
    the pages (and an int8 pool's scale rows) are written IN PLACE, layer by
    layer, each after its layer's splice read.  Returns (logits (A, V)
    float32, cache)."""
    del slots                           # dense state is fully page-resident
    h = params["embed"][tokens]
    b, s, _ = h.shape
    page = cache["kp"].shape[2]
    npg = s // page
    pos = torch.arange(s, device=h.device)
    wrows = (block_rows[:, :npg] if start is None
             else L.suffix_write_rows(block_rows, start, npg, page))
    for i, win in enumerate(layer_windows(cfg, s)):
        pk, pv = cache["kp"][i], cache["vp"][i]
        sc = scales(cache, i)
        splice = None if start is None else (
            pk, pv, sc["scale_k"], sc["scale_v"], block_rows, start)
        h, k, v = _prefill_layer(layer_params(params["layers"], i), cfg, h,
                                 win, pk.dtype, pos, splice, page, ffn)
        store_prefill_pages(pk, pv, sc, k, v, wrows)
    h = L.rmsnorm(params["final_norm"], h, cfg.norm_eps)
    last = (lengths.long() - 1)[:, None, None].expand(-1, 1, h.shape[-1])
    h = torch.gather(h, 1, last)
    logits = L.lm_logits(h[:, 0, :], params["lm_head"])
    return logits, cache


def store_prefill_pages(pk: torch.Tensor, pv: torch.Tensor,
                        sc: Dict[str, Any], k: torch.Tensor, v: torch.Tensor,
                        wrows: torch.Tensor) -> None:
    """One layer's (group's) prefill K/V into its pages, IN PLACE: rounded
    to the pool dtype, or quantised with fresh scales (``sc`` from
    :func:`scales`) from the raw values."""
    if sc["scale_k"] is None:
        L.scatter_prefill_pages(pk, k, wrows)
        L.scatter_prefill_pages(pv, v, wrows)
        return
    L.quant_scatter_prefill_pages(pk, sc["scale_k"], k, wrows)
    L.quant_scatter_prefill_pages(pv, sc["scale_v"], v, wrows)


def decode_step_paged(params: Params, cfg: ModelConfig, token: torch.Tensor,
                      pos: torch.Tensor, block: torch.Tensor, cache: Params,
                      *, write_block: Optional[torch.Tensor] = None,
                      ffn: FFN = dense_ffn) -> Tuple[torch.Tensor, Params]:
    """One decode step for all slots at per-slot positions.
    token: (B, 1); pos: (B,); block: (B, n_pages) int32.  Returns
    (logits (B, V) float32, cache), the pools written in place."""
    h = params["embed"][token]
    page = cache["kp"].shape[2]
    for i, win in enumerate(layer_windows(cfg, block.shape[1] * page)):
        lp = layer_params(params["layers"], i)
        h = h + L.attention_decode_paged(
            lp["attn"], L.rmsnorm(lp["ln1"], h, cfg.norm_eps),
            cache["kp"][i], cache["vp"][i], block, pos,
            num_heads=cfg.num_heads, num_kv=cfg.num_kv_heads,
            head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
            window=win, write_block=write_block, **scales(cache, i))
        h = h + ffn(lp, cfg, L.rmsnorm(lp["ln2"], h, cfg.norm_eps))
    h = L.rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return L.lm_logits(h[:, 0, :], params["lm_head"]), cache


def forward_chunk_paged(params: Params, cfg: ModelConfig,
                        tokens: torch.Tensor, pos: torch.Tensor,
                        block: torch.Tensor, cache: Params, *,
                        write_block: Optional[torch.Tensor] = None,
                        ffn: FFN = dense_ffn
                        ) -> Tuple[torch.Tensor, Params, dict]:
    """The chunked token lane: tokens (B, C) for all slots at per-slot start
    positions in one multi-token paged pass.  Attention state is positional,
    so the staged snapshot dict is empty.  Returns (logits (B, C, V) float32,
    cache, {})."""
    h = params["embed"][tokens]
    page = cache["kp"].shape[2]
    for i, win in enumerate(layer_windows(cfg, block.shape[1] * page)):
        lp = layer_params(params["layers"], i)
        h = h + L.attention_chunk_paged(
            lp["attn"], L.rmsnorm(lp["ln1"], h, cfg.norm_eps),
            cache["kp"][i], cache["vp"][i], block, pos,
            num_heads=cfg.num_heads, num_kv=cfg.num_kv_heads,
            head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
            window=win, write_block=write_block, **scales(cache, i))
        h = h + ffn(lp, cfg, L.rmsnorm(lp["ln2"], h, cfg.norm_eps))
    h = L.rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return L.lm_logits(h, params["lm_head"]), cache, {}
