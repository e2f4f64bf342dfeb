"""Zamba2-style hybrid: a Mamba-2 backbone with one SHARED attention block
applied after every ``shared_attn_every`` layers [arXiv:2411.15242].

The ``G = num_layers // shared_attn_every`` groups each run k mamba layers
and then the shared block (one set of weights, applied G times).  Block
params are stacked (G, k, ...); recurrent leaves are (G, k, rows, ...),
slot axis 2, and the mamba helpers of ``mamba2.py`` run on them with that
axis.  The shared block's K/V live in a contiguous (G, B, S, K, Dh) cache
(drain path) or a (G, P, page, K, Dh) page pool indexed by the scheduler's
one block table (continuous serving; one physical page holds one group's
K/V for a page of positions), which under int8 carries (G, P, K) float32
scale rows; the mamba state stays float32 and the conv window bf16.
Everything is updated IN PLACE.

Prompt attention runs in plain torch (``layers._sdpa``), as the
reference's; decode attention goes through ``ops`` (the hand-written
kernels on the card).  The prefix cache shares whole prompts only: the
mamba state has no mid-prompt snapshot.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models.transformer import (_dense, _normal, layer_params,
                                            maybe_remat, paged_kv, scales,
                                            store_prefill_pages)
from repro_torch.sharding import act

Params = Dict[str, Any]
# slot axis of the recurrent leaves (G, k, B, ...): the rollback stages,
# snapshots and chunk-lane rows are ``mamba2``'s helpers on this axis
AXIS = 2


def _num_groups(cfg: ModelConfig) -> int:
    k = cfg.shared_attn_every
    if cfg.num_layers % k:
        raise ValueError(f"num_layers {cfg.num_layers} must divide by "
                         f"shared_attn_every {k}")
    return cfg.num_layers // k


def init_model(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Random float32 params with the reference's shapes, layout and
    scales, on the generator's device."""
    g, k = _num_groups(cfg), cfg.shared_attn_every
    d, hd, ff = cfg.d_model, cfg.resolved_head_dim, cfg.d_ff
    hq, hk = cfg.num_heads * hd, cfg.num_kv_heads * hd
    dev = gen.device
    layers = M.init_mamba_blocks(gen, cfg, (g, k))
    shared = {"ln1": {"scale": torch.ones(d, device=dev)},
              "attn": {"wq": _dense(gen, (d, hq)), "wk": _dense(gen, (d, hk)),
                       "wv": _dense(gen, (d, hk)), "wo": _dense(gen, (hq, d))},
              "ln2": {"scale": torch.ones(d, device=dev)},
              "mlp": {"wi": _dense(gen, (d, ff)), "wg": _dense(gen, (d, ff)),
                      "wo": _dense(gen, (ff, d))}}
    return {"embed": _normal(gen, (cfg.vocab_size, d), 0.02),
            "layers": layers,
            "shared_attn": shared,
            "final_norm": {"scale": torch.ones(d, device=dev)},
            "lm_head": _dense(gen, (d, cfg.vocab_size))}


def _attn_kw(cfg: ModelConfig) -> dict:
    return dict(num_heads=cfg.num_heads, num_kv=cfg.num_kv_heads,
                head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta)


def _mlp(sp: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    return x + L.swiglu(sp["mlp"], L.rmsnorm(sp["ln2"], x, cfg.norm_eps))


def _layers(params: Params, cfg: ModelConfig):
    """(group, layer index in group, layer params) in order."""
    for gi in range(_num_groups(cfg)):
        gp = layer_params(params["layers"], gi)
        for kk in range(cfg.shared_attn_every):
            yield gi, kk, layer_params(gp, kk)


def _group(gp: Params, sp: Params, cfg: ModelConfig,
           h: torch.Tensor) -> torch.Tensor:
    """One group: its ``shared_attn_every`` mamba layers, then the shared
    attention block."""
    for kk in range(cfg.shared_attn_every):
        lp = layer_params(gp, kk)
        h = h + M.mamba_block(lp, cfg, L.rmsnorm(lp["ln"], h, cfg.norm_eps))
    h = h + L.attention_forward(
        sp["attn"], L.rmsnorm(sp["ln1"], h, cfg.norm_eps), **_attn_kw(cfg))
    return _mlp(sp, cfg, h)


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            remat: bool = False, last_only: bool = False) -> torch.Tensor:
    """tokens: (B, S) -> logits (B, S, V) float32 ((B, 1, V) with
    ``last_only``); ``remat`` checkpoints each group, as the reference
    does."""
    h = params["embed"][tokens]
    group = maybe_remat(_group, remat)
    for gi in range(_num_groups(cfg)):
        h = group(layer_params(params["layers"], gi), params["shared_attn"],
                  cfg, h)
    return M._head(params, cfg, h, last_only)


# ---------------------------------------------------------------------------
# prefill (shared by the contiguous cache and the page pool)
# ---------------------------------------------------------------------------

def _prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
             states: Params, rows: Optional[torch.Tensor], kv_dtype,
             length: Optional[torch.Tensor], store_kv,
             page: int = 0) -> torch.Tensor:
    """The group loop of :func:`prefill` and :func:`prefill_paged` (the
    reference's ``_prefill_outer``): each mamba layer's state and conv
    window go to ``states`` rows ``rows`` (all rows when None), each
    group's shared-attention K/V (rounded to the cache dtype before the
    in-pass attention) to ``store_kv(group, k, v)``.  ``kv_dtype`` int8 (a
    ``page``-position pool): the in-pass attention sees K/V fake-quantised
    on the per-page grid and ``store_kv`` gets the raw values, whose
    quantised write recomputes the same scales.  Returns the final hidden
    states (B, S, D)."""
    h = params["embed"][tokens]
    b, s, _ = h.shape
    sp = params["shared_attn"]
    hd = cfg.resolved_head_dim
    pos = torch.arange(s, device=h.device)
    k = cfg.shared_attn_every
    for gi, kk, lp in _layers(params, cfg):
        y, st, cw = M.mamba_block_prefill(
            lp, cfg, L.rmsnorm(lp["ln"], h, cfg.norm_eps),
            conv_dtype=states["conv"].dtype, length=length)
        h = h + y
        if rows is None:
            states["state"][gi, kk] = st
            states["conv"][gi, kk] = cw
        else:
            states["state"][gi, kk, rows] = st
            states["conv"][gi, kk, rows] = cw
        if kk < k - 1:
            continue
        q, kt, vt = L._qkv(sp["attn"], L.rmsnorm(sp["ln1"], h, cfg.norm_eps),
                           cfg.num_heads, cfg.num_kv_heads, hd)
        if cfg.rope_theta > 0:
            q = L.apply_rope(q, pos, cfg.rope_theta)
            kt = L.apply_rope(kt, pos, cfg.rope_theta)
        if kv_dtype == torch.int8:
            k_in = L.quant_dequant_pages(kt, page)
            v_in = L.quant_dequant_pages(vt, page)
        else:
            kt, vt = kt.to(kv_dtype), vt.to(kv_dtype)
            k_in, v_in = kt, vt
        a = L._sdpa(q, k_in, v_in, L.causal_window_mask(s, s,
                                                        device=h.device))
        h = h + act.reduce_model(
            a.reshape(b, s, cfg.num_heads * hd) @ sp["attn"]["wo"], "attn")
        h = _mlp(sp, cfg, h)
        store_kv(gi, kt, vt)
    return h


# ---------------------------------------------------------------------------
# contiguous cache (drain path)
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               dtype=torch.bfloat16, device="cuda") -> Params:
    g, k = _num_groups(cfg), cfg.shared_attn_every
    kv = (g, batch, seq_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {**M.state_rows(cfg, (g, k), batch, dtype, device),
            "k": torch.zeros(kv, dtype=dtype, device=device),
            "v": torch.zeros(kv, dtype=dtype, device=device),
            "pos": 0}


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            cache: Params) -> Tuple[torch.Tensor, Params]:
    """Consume the (B, S) prompt in one batched pass, writing the SSM
    states, conv windows and each group's K/V rows [0, S) in place.
    Returns (last-position logits (B, V) float32, cache)."""
    s = tokens.shape[1]

    def store_kv(gi, k, v):
        cache["k"][gi, :, :s] = k
        cache["v"][gi, :, :s] = v

    h = _prefill(params, cfg, tokens, cache, None, cache["k"].dtype, None,
                 store_kv)
    logits = M._head(params, cfg, h[:, -1:])[:, 0]
    return logits, {**cache, "pos": s}


def decode_step(params: Params, cfg: ModelConfig, token: torch.Tensor,
                cache: Params) -> Tuple[torch.Tensor, Params]:
    """token: (B, 1) -> (logits (B, V) float32, cache advanced in place).
    The shared block's decode attention goes through ``ops``."""
    h = params["embed"][token]
    sp = params["shared_attn"]
    pos = cache["pos"]
    k = cfg.shared_attn_every
    for gi, kk, lp in _layers(params, cfg):
        h = h + M.mamba_block_step(lp, cfg,
                                   L.rmsnorm(lp["ln"], h, cfg.norm_eps),
                                   cache["state"][gi, kk],
                                   cache["conv"][gi, kk])
        if kk == k - 1:
            h = h + L.attention_decode(
                sp["attn"], L.rmsnorm(sp["ln1"], h, cfg.norm_eps),
                cache["k"][gi], cache["v"][gi], pos, **_attn_kw(cfg))
            h = _mlp(sp, cfg, h)
    logits = M._head(params, cfg, h)[:, 0]
    return logits, {**cache, "pos": pos + 1}


# ---------------------------------------------------------------------------
# paged API (continuous serving)
# ---------------------------------------------------------------------------

def init_paged_cache(cfg: ModelConfig, num_slots: int, num_pages: int,
                     page_size: int, dtype=torch.bfloat16,
                     device="cuda") -> Params:
    """Per-slot mamba rows (plus the padding row ``num_slots``) and the
    shared block's (G, P, page, K, Dh) K/V pools; under int8 the pools'
    (G, P, K) scale rows, with the recurrent rows kept at full precision
    (float32 state, bf16 conv window: per-slot and constant-size, they are
    not paged)."""
    g, k = _num_groups(cfg), cfg.shared_attn_every
    return {**M.state_rows(cfg, (g, k), num_slots + 1, dtype, device),
            **paged_kv(g, num_pages, page_size, cfg.num_kv_heads,
                       cfg.resolved_head_dim, dtype, device)}


def init_prefix_cache(cfg: ModelConfig, entries: int, dtype=torch.bfloat16,
                      device="cuda") -> Params:
    """Full-prompt snapshot rows of the mamba half (plus the drop row
    ``entries``); the shared block's prompt K/V need none, their pages are
    retained by the pool's prefix index and aliased on restore.  Under
    int8 the rows stay bf16 / float32 (``mamba2.state_rows``)."""
    g, k = _num_groups(cfg), cfg.shared_attn_every
    return M.state_rows(cfg, (g, k), entries + 1, dtype, device)


def snapshot_save(cfg: ModelConfig, cache: Params, prefix: Params,
                  rows: torch.Tensor, slots: torch.Tensor) -> Params:
    return M.copy_rows(prefix, rows, cache, slots, axis=AXIS)


def snapshot_restore(cfg: ModelConfig, cache: Params, prefix: Params,
                     rows: torch.Tensor, slots: torch.Tensor) -> Params:
    return M.copy_rows(cache, slots, prefix, rows, axis=AXIS)


def prefill_paged(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  lengths: torch.Tensor, slots: torch.Tensor,
                  block_rows: torch.Tensor, cache: Params, *,
                  start: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Params]:
    """Prefill admitted requests: the mamba rows land in slots ``slots``
    (the sentinel in the padding row), the shared block's K/V in each
    slot's pages, all in place.  The group math is :func:`prefill`'s.

    ``start``: prompts are shared whole, so per row it is 0 (a miss, full
    prefill) or the bucket (a restore: every page write goes to the null
    page, the aliased prompt pages being read-only)."""
    s = tokens.shape[1]
    page = cache["kp"].shape[2]
    npg = s // page
    wrows = (block_rows[:, :npg] if start is None
             else L.suffix_write_rows(block_rows, start, npg, page))

    def store_kv(gi, k, v):
        store_prefill_pages(cache["kp"][gi], cache["vp"][gi],
                            scales(cache, gi), k, v, wrows)

    h = _prefill(params, cfg, tokens, cache, slots.long(),
                 cache["kp"].dtype, lengths, store_kv, page)
    return M._head(params, cfg, M._last(h, lengths)[:, None])[:, 0], cache


def _step_paged(params: Params, cfg: ModelConfig, token: torch.Tensor,
                pos: torch.Tensor, block: torch.Tensor, cache: Params,
                write_block) -> torch.Tensor:
    """All groups' step over rows [:B], in place; returns logits (B, V)."""
    h = params["embed"][token]
    b = token.shape[0]
    sp = params["shared_attn"]
    k = cfg.shared_attn_every
    for gi, kk, lp in _layers(params, cfg):
        h = h + M.mamba_block_step(lp, cfg,
                                   L.rmsnorm(lp["ln"], h, cfg.norm_eps),
                                   cache["state"][gi, kk, :b],
                                   cache["conv"][gi, kk, :b])
        if kk == k - 1:
            h = h + L.attention_decode_paged(
                sp["attn"], L.rmsnorm(sp["ln1"], h, cfg.norm_eps),
                cache["kp"][gi], cache["vp"][gi], block, pos,
                write_block=write_block, **scales(cache, gi),
                **_attn_kw(cfg))
            h = _mlp(sp, cfg, h)
    return M._head(params, cfg, h)[:, 0]


def decode_step_paged(params: Params, cfg: ModelConfig, token: torch.Tensor,
                      pos: torch.Tensor, block: torch.Tensor, cache: Params,
                      *, write_block: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Params]:
    """One decode step for all B slots at per-slot positions ``pos``; the
    shared block appends through ``write_block`` and reads the pages
    through ``block`` with the paged decode kernel."""
    return _step_paged(params, cfg, token, pos, block, cache,
                       write_block), cache


def forward_chunk_paged(params: Params, cfg: ModelConfig,
                        tokens: torch.Tensor, pos: torch.Tensor,
                        block: torch.Tensor, cache: Params, *,
                        write_block: Optional[torch.Tensor] = None,
                        keep=None) -> Tuple[torch.Tensor, Params, dict]:
    """The chunk lane for the hybrid: C per-token steps (bitwise C
    :func:`decode_step_paged` calls; the mamba half is sequential), token
    j of slot b at ``pos[b] + j``.  The shared block's K/V land in the
    pages positionally (a rollback rewinds the host position); the mamba
    rows are staged as in ``mamba2.chunk_steps``."""
    return M.chunk_steps(
        lambda tok, j: _step_paged(params, cfg, tok, pos + j, block, cache,
                                   write_block),
        tokens, cache, keep, axis=AXIS)
