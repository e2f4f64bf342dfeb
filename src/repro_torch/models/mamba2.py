"""Mamba-2 (SSD, state-space duality, arXiv:2405.21060): the SSM family.

Prefill and the full-sequence forward use the chunked SSD algorithm
through ``ops.ssd`` (the hand-written intra-chunk kernel on the card, its
plain version on the CPU, and the inter-chunk recurrence in torch).  Decode
and the chunk lane are the O(1)-per-token recurrent update on the cached
state, as in the reference; they launch no SSD kernel.

The reference scans one block body over ``(L, ...)``-stacked params; here a
python loop walks the same stacked params layer by layer.  Caches are
updated IN PLACE, where the reference donates them:

* the contiguous cache (drain path) holds ``state`` (L, B, H, P, N) float32,
  ``conv`` (L, B, W-1, conv_dim) and ``pos``, a python int;
* the paged cache (continuous serving) holds per-slot rows of the same
  leaves, (L, num_slots + 1, ...).  The SSM state is constant-size per
  sequence, so there is nothing to page and the block table is ignored.
  Row ``num_slots`` is the padding row that the scheduler's slot sentinel
  (``== num_slots``, the reference's ``mode="drop"``) writes into; steps
  over B slots read and write rows ``[:B]`` only;
* the prefix cache holds full-prompt snapshot rows (L, entries + 1, ...),
  row ``entries`` being the drop row of the sentinel saves.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.transformer import (_dense, _normal, layer_params,
                                            maybe_remat)

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------

def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, chunk: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's all-jnp chunked SSD, in plain torch (the oracle the
    tests hold ``ops.ssd`` against).  x: (b, l, h, p); dt: (b, l, h)
    (softplus applied); A: (h,); B/C: (b, l, n).  Returns
    (y (b, l, h, p), final state (b, h, p, n) float32)."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    chunk = min(chunk, l)
    orig_l = l
    if l % chunk:
        # pad with dt = 0 steps: decay 1 and zero input, a no-op on state
        pad = chunk - l % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
        l += pad
    nc = l // chunk
    f32 = torch.float32
    a = (dt.to(f32) * A.to(f32)).reshape(b, nc, chunk, h)
    dx = (x.to(f32) * dt.to(f32)[..., None]).reshape(b, nc, chunk, h, p)
    Bc = B.to(f32).reshape(b, nc, chunk, n)
    Cc = C.to(f32).reshape(b, nc, chunk, n)
    a_cs = torch.cumsum(a, dim=2)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    decay = torch.exp(a_cs[:, :, :, None, :] - a_cs[:, :, None, :, :])
    decay = torch.where(tri[None, None, :, :, None], decay, 0.0)
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    y_diag = torch.einsum("bcij,bcijh,bcjhp->bcihp", cb, decay, dx)
    decay_to_end = torch.exp(a_cs[:, :, -1:, :] - a_cs)
    S = torch.einsum("bcjh,bcjhp,bcjn->bchpn", decay_to_end, dx, Bc)
    g = torch.exp(a_cs[:, :, -1, :])
    hprev = torch.zeros((b, h, p, n), dtype=f32, device=x.device)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(hprev)
        hprev = g[:, c, :, None, None] * hprev + S[:, c]
    y_off = torch.einsum("bcih,bcin,bchpn->bcihp", torch.exp(a_cs), Cc,
                         torch.stack(h_prevs, dim=1))
    y = (y_diag + y_off).reshape(b, l, h, p)[:, :orig_l]
    return y.to(x.dtype), hprev


def ssd_recurrent_step(state: torch.Tensor, x_t: torch.Tensor,
                       dt_t: torch.Tensor, A: torch.Tensor,
                       B_t: torch.Tensor, C_t: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step, updating ``state`` (b, h, p, n) float32 IN PLACE
    (``exp(dt A) * state + dt x B^T``, the reference's two roundings).
    x_t: (b, h, p); dt_t: (b, h); B_t/C_t: (b, n).  Returns
    (y_t (b, h, p), state)."""
    f32 = torch.float32
    da = torch.exp(dt_t.to(f32) * A.to(f32))
    dx = x_t.to(f32) * dt_t.to(f32)[..., None]
    state.mul_(da[:, :, None, None]).add_(
        dx[..., None] * B_t.to(f32)[:, None, None, :])
    y = torch.einsum("bhpn,bn->bhp", state, C_t.to(f32))
    return y.to(x_t.dtype), state


# ---------------------------------------------------------------------------
# causal depthwise conv (width W, per channel)
# ---------------------------------------------------------------------------

def causal_conv(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """x: (B, L, C); w: (W, C); b: (C,).  Shift and sum (W is tiny)."""
    W, l = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = sum(xp[:, i:i + l, :] * w[i] for i in range(W))
    return out + b


def causal_conv_step(window: torch.Tensor, x_t: torch.Tensor,
                     w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """window: (B, W-1, C) previous raw inputs, rolled IN PLACE (kept in its
    own dtype); x_t: (B, 1, C).  Returns y_t (B, 1, C)."""
    full = torch.cat([window.to(x_t.dtype), x_t], dim=1)          # (B, W, C)
    y = torch.einsum("bwc,wc->bc", full, w) + b
    window.copy_(full[:, 1:, :])
    return y[:, None, :]


# ---------------------------------------------------------------------------
# block init / forward
# ---------------------------------------------------------------------------

def init_mamba_blocks(gen: torch.Generator, cfg: ModelConfig,
                      lead: Tuple[int, ...]) -> Params:
    """Random float32 block params stacked on ``lead`` axes, with the
    reference's shapes, layout and scales (A = -exp(0) = -1, D = 1)."""
    d, di = cfg.d_model, cfg.ssm_d_inner
    n, h, W = cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_conv_width
    conv_dim = di + 2 * n
    dev = gen.device

    def full(value, *shape):
        return torch.full((*lead, *shape), value, dtype=torch.float32,
                          device=dev)

    return {"ln": {"scale": full(1.0, d)},
            "in_proj": _dense(gen, (*lead, d, 2 * di + 2 * n + h)),
            "conv_w": _normal(gen, (*lead, W, conv_dim), 0.1),
            "conv_b": full(0.0, conv_dim),
            "A_log": full(0.0, h),
            "D": full(1.0, h),
            "dt_bias": full(0.0, h),
            "norm": {"scale": full(1.0, di)},
            "out_proj": _dense(gen, (*lead, di, d))}


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    di, n = cfg.ssm_d_inner, cfg.ssm_state
    return (zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * n],
            zxbcdt[..., 2 * di + 2 * n:])


def _ssd_inputs(lp: Params, cfg: ModelConfig, xbc: torch.Tensor,
                dt: torch.Tensor):
    """Conv'd, activated xbc and raw dt -> (xs (b, l, h, p), B, C, dt, A)."""
    b, l = xbc.shape[:2]
    di, n = cfg.ssm_d_inner, cfg.ssm_state
    xbc = F.silu(causal_conv(xbc, lp["conv_w"], lp["conv_b"]))
    xs = xbc[..., :di].reshape(b, l, cfg.ssm_nheads, cfg.ssm_head_dim)
    dt = F.softplus(dt.float() + lp["dt_bias"])
    return xs, xbc[..., di:di + n], xbc[..., di + n:], dt, -torch.exp(
        lp["A_log"])


def _block_out(lp: Params, cfg: ModelConfig, y: torch.Tensor,
               xs: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    y = y + lp["D"].to(y.dtype)[:, None] * xs
    y = y.reshape(*z.shape[:-1], cfg.ssm_d_inner)
    y = L.rmsnorm(lp["norm"], y * F.silu(z), cfg.norm_eps)
    return y @ lp["out_proj"]


def mamba_block(lp: Params, cfg: ModelConfig,
                x: torch.Tensor) -> torch.Tensor:
    """Full-sequence block (the caller applies the pre-norm residual)."""
    z, xbc, dt = _split_proj(cfg, x @ lp["in_proj"])
    xs, B, C, dt, A = _ssd_inputs(lp, cfg, xbc, dt)
    y, _ = ops.ssd(xs, dt, A, B, C, chunk=cfg.ssm_chunk)
    return _block_out(lp, cfg, y, xs, z)


def mamba_block_prefill(lp: Params, cfg: ModelConfig, x: torch.Tensor, *,
                        conv_dtype=torch.bfloat16,
                        length: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence block that also emits the decode-cache entries.

    Returns (y (B, L, D), final state (B, H, P, N) float32, conv window
    (B, W-1, conv_dim)): the window holds the last W-1 raw (pre-activation)
    conv inputs, zero-padded on the left for short prompts.

    ``length`` (B,) (paged serving): each prompt is right-padded to the
    bucket; positions >= its length get dt = 0 after the softplus, exact
    no-ops on the state (decay 1, zero input), and the conv window is
    gathered to END at the row's length.  Rows of y are valid below their
    lengths only."""
    b, l, _ = x.shape
    W = cfg.ssm_conv_width
    z, xbc, dt = _split_proj(cfg, x @ lp["in_proj"])
    if length is None:
        win = F.pad(xbc, (0, 0, W - 1, 0))[:, l:, :]
    else:
        lens = length.long().reshape(-1).expand(b)
        idx = lens[:, None] - (W - 1) + torch.arange(W - 1, device=x.device)
        live = (idx >= 0)[:, :, None]
        win = torch.gather(xbc, 1, idx.clamp(0, l - 1)[:, :, None].expand(
            -1, -1, xbc.shape[-1])) * live
    win = win.to(conv_dtype)
    xs, B, C, dt, A = _ssd_inputs(lp, cfg, xbc, dt)
    if length is not None:
        pos = torch.arange(l, device=x.device)[None, :, None]
        dt = torch.where(pos < lens[:, None, None], dt, 0.0)
    y, state = ops.ssd(xs, dt, A, B, C, chunk=cfg.ssm_chunk)
    return _block_out(lp, cfg, y, xs, z), state, win


def mamba_block_step(lp: Params, cfg: ModelConfig, x: torch.Tensor,
                     state: torch.Tensor, conv_win: torch.Tensor
                     ) -> torch.Tensor:
    """One-token step; x: (B, 1, D).  ``state`` (B, H, P, N) and
    ``conv_win`` (B, W-1, conv_dim) are advanced IN PLACE (views into the
    cache).  Returns y (B, 1, D)."""
    b = x.shape[0]
    di, n = cfg.ssm_d_inner, cfg.ssm_state
    z, xbc, dt = _split_proj(cfg, x @ lp["in_proj"])
    xbc_t = F.silu(causal_conv_step(conv_win, xbc, lp["conv_w"],
                                    lp["conv_b"]))
    xs = xbc_t[:, 0, :di].reshape(b, cfg.ssm_nheads, cfg.ssm_head_dim)
    dt = F.softplus(dt[:, 0].float() + lp["dt_bias"])
    y, _ = ssd_recurrent_step(state, xs, dt, -torch.exp(lp["A_log"]),
                              xbc_t[:, 0, di:di + n], xbc_t[:, 0, di + n:])
    return _block_out(lp, cfg, y[:, None], xs[:, None], z)


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------

def init_model(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Random float32 params with the reference's shapes, layout and
    scales, on the generator's device."""
    d = cfg.d_model
    return {"embed": _normal(gen, (cfg.vocab_size, d), 0.02),
            "layers": init_mamba_blocks(gen, cfg, (cfg.num_layers,)),
            "final_norm": {"scale": torch.ones(d, device=gen.device)},
            "lm_head": _dense(gen, (d, cfg.vocab_size))}


def _head(params: Params, cfg: ModelConfig, h: torch.Tensor,
          last_only: bool = False) -> torch.Tensor:
    h = L.rmsnorm(params["final_norm"], h, cfg.norm_eps)
    if last_only:
        h = h[:, -1:]
    return L.lm_logits(h, params["lm_head"])


def _last(h: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """(A, S, D) -> (A, D): each row at ``lengths - 1``."""
    idx = (lengths.long() - 1)[:, None, None].expand(-1, 1, h.shape[-1])
    return torch.gather(h, 1, idx)[:, 0]


def _layer(lp: Params, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    return h + mamba_block(lp, cfg, L.rmsnorm(lp["ln"], h, cfg.norm_eps))


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            remat: bool = False, last_only: bool = False) -> torch.Tensor:
    """tokens: (B, S) -> logits (B, S, V) float32 ((B, 1, V) with
    ``last_only``); ``remat`` checkpoints each layer."""
    h = params["embed"][tokens]
    layer = maybe_remat(_layer, remat)
    for i in range(cfg.num_layers):
        h = layer(layer_params(params["layers"], i), cfg, h)
    return _head(params, cfg, h, last_only)


def state_rows(cfg: ModelConfig, lead: Tuple[int, ...], rows: int,
               dtype=torch.bfloat16, device="cuda") -> Params:
    """Zeroed recurrent rows: ``state`` (*lead, rows, H, P, N) float32 and
    ``conv`` (*lead, rows, W-1, conv_dim) of ``dtype`` (int8 pools keep a
    bf16 window: the recurrent carry stays full precision)."""
    if dtype == torch.int8:
        dtype = torch.bfloat16
    state = (cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_state)
    conv = (cfg.ssm_conv_width - 1, cfg.ssm_d_inner + 2 * cfg.ssm_state)
    return {"state": torch.zeros((*lead, rows, *state), dtype=torch.float32,
                                 device=device),
            "conv": torch.zeros((*lead, rows, *conv), dtype=dtype,
                                device=device)}


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               dtype=torch.bfloat16, device="cuda") -> Params:
    """Decode cache: per-layer state + conv window, constant in seq_len."""
    del seq_len
    return {**state_rows(cfg, (cfg.num_layers,), batch, dtype, device),
            "pos": 0}


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            cache: Params) -> Tuple[torch.Tensor, Params]:
    """Consume the (B, S) prompt with the chunked SSD pass; each layer's
    state and conv window are written into ``cache`` IN PLACE.  Returns
    (last-position logits (B, V) float32, cache)."""
    h = params["embed"][tokens]
    for i in range(cfg.num_layers):
        lp = layer_params(params["layers"], i)
        y, st, cw = mamba_block_prefill(
            lp, cfg, L.rmsnorm(lp["ln"], h, cfg.norm_eps),
            conv_dtype=cache["conv"].dtype)
        h = h + y
        cache["state"][i] = st
        cache["conv"][i] = cw
    logits = _head(params, cfg, h[:, -1:])[:, 0]
    return logits, {"state": cache["state"], "conv": cache["conv"],
                    "pos": tokens.shape[1]}


def _step(params: Params, cfg: ModelConfig, token: torch.Tensor,
          cache: Params) -> torch.Tensor:
    """All layers' recurrent step over rows [:B] of the cache, in place."""
    h = params["embed"][token]
    b = token.shape[0]
    for i in range(cfg.num_layers):
        lp = layer_params(params["layers"], i)
        h = h + mamba_block_step(lp, cfg, L.rmsnorm(lp["ln"], h, cfg.norm_eps),
                                 cache["state"][i, :b], cache["conv"][i, :b])
    return _head(params, cfg, h)[:, 0]


def decode_step(params: Params, cfg: ModelConfig, token: torch.Tensor,
                cache: Params) -> Tuple[torch.Tensor, Params]:
    """token: (B, 1) -> (logits (B, V) float32, cache advanced in place)."""
    logits = _step(params, cfg, token, cache)
    return logits, {"state": cache["state"], "conv": cache["conv"],
                    "pos": cache["pos"] + 1}


# ---------------------------------------------------------------------------
# paged API (continuous serving)
# ---------------------------------------------------------------------------

def init_paged_cache(cfg: ModelConfig, num_slots: int, num_pages: int,
                     page_size: int, dtype=torch.bfloat16,
                     device="cuda") -> Params:
    """Per-slot state rows plus the padding row ``num_slots``."""
    del num_pages, page_size
    return state_rows(cfg, (cfg.num_layers,), num_slots + 1, dtype, device)


def init_prefix_cache(cfg: ModelConfig, entries: int, dtype=torch.bfloat16,
                      device="cuda") -> Params:
    """Full-prompt snapshot rows (state + conv window at the prompt
    boundary) plus the drop row ``entries``: one row restores the WHOLE
    prompt, the recurrent families' equivalent of aliasing every page."""
    return state_rows(cfg, (cfg.num_layers,), entries + 1, dtype, device)


def _rows(t: torch.Tensor, axis: int) -> torch.Tensor:
    """View of a recurrent leaf with its row axis first."""
    return t.movedim(axis, 0)


def copy_rows(dst: Params, dst_idx: torch.Tensor, src: Params,
              src_idx: Optional[torch.Tensor], axis: int) -> Params:
    """dst[rows dst_idx] = src[rows src_idx] (all rows of src when
    ``src_idx`` is None) for ``state`` and ``conv``, IN PLACE, rows on
    ``axis``.  Sentinel indices land in the padding / drop rows."""
    for key in ("state", "conv"):
        s = _rows(src[key], axis)
        if src_idx is not None:
            s = s[src_idx.long()]
        _rows(dst[key], axis)[dst_idx.long()] = s
    return dst


def snapshot_save(cfg: ModelConfig, cache: Params, prefix: Params,
                  rows: torch.Tensor, slots: torch.Tensor) -> Params:
    """Admitted slots' post-prefill state into prefix rows, in place
    (rows == entries: the drop row)."""
    return copy_rows(prefix, rows, cache, slots, axis=1)


def snapshot_restore(cfg: ModelConfig, cache: Params, prefix: Params,
                     rows: torch.Tensor, slots: torch.Tensor) -> Params:
    """Prefix rows into decode slots (full-prompt hit), in place
    (slots == num_slots: the padding row)."""
    return copy_rows(cache, slots, prefix, rows, axis=1)


def prefill_paged(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  lengths: torch.Tensor, slots: torch.Tensor,
                  block_rows: torch.Tensor, cache: Params, *,
                  start=None) -> Tuple[torch.Tensor, Params]:
    """Prefill admitted requests into decode slots ``slots``, in place.

    tokens: (A, S_max) right-padded; each row's positions >= lengths[i] are
    state no-ops (dt = 0) and its logits are read at lengths[i] - 1.
    Padded admission rows carry the sentinel slot and write the padding
    row.  ``start`` is unused: the SSM family shares whole prompts only
    (snapshot / restore); a restored row runs here as a passive member
    whose slot the restore overwrites afterwards."""
    del block_rows, start
    h = params["embed"][tokens]
    idx = slots.long()
    for i in range(cfg.num_layers):
        lp = layer_params(params["layers"], i)
        y, st, cw = mamba_block_prefill(
            lp, cfg, L.rmsnorm(lp["ln"], h, cfg.norm_eps),
            conv_dtype=cache["conv"].dtype, length=lengths)
        h = h + y
        cache["state"][i, idx] = st
        cache["conv"][i, idx] = cw
    return _head(params, cfg, _last(h, lengths)[:, None])[:, 0], cache


def decode_step_paged(params: Params, cfg: ModelConfig, token: torch.Tensor,
                      pos: torch.Tensor, block: torch.Tensor, cache: Params,
                      *, write_block=None) -> Tuple[torch.Tensor, Params]:
    """One step for all B slots (rows [:B]); the recurrence is position
    free, so ``pos`` / ``block`` / ``write_block`` are unused.  Idle slots
    advance garbage state that admission overwrites."""
    del pos, block, write_block
    return _step(params, cfg, token, cache), cache


def snapshot_rows(cache: Params, b: int, axis: int) -> Params:
    """A copy of rows [:b] of the recurrent leaves (rows on ``axis``)."""
    return {k: _rows(cache[k], axis)[:b].movedim(0, axis).clone()
            for k in ("state", "conv")}


def chunk_steps(step, tokens: torch.Tensor, cache: Params, keep, axis: int):
    """The recurrent chunk lane: C per-token steps, ``step(tok (B, 1), j)``
    -> logits (B, V), updating ``cache`` in place.  Returns (logits
    (B, C, V), cache, staged): with ``keep`` None, ``staged`` stacks every
    step's {state, conv} of the B rows (leading axis C: the reference's
    boundary snapshots); with ``keep`` (B,) host ints, it holds only each
    row's snapshot after exactly ``max(keep, 1)`` inputs, which is
    ``select_stage(staged, keep)`` without holding C snapshots."""
    b, c = tokens.shape
    pick = None if keep is None else [max(int(k) - 1, 0) for k in keep]
    logits, snaps = [], {}
    for j in range(c):
        logits.append(step(tokens[:, j:j + 1], j))
        if pick is None or j in pick:
            snaps[j] = snapshot_rows(cache, b, axis)
    if pick is None:
        staged = {k: torch.stack([snaps[j][k] for j in range(c)])
                  for k in ("state", "conv")}
    else:
        staged = {k: torch.empty_like(snaps[pick[0]][k])
                  for k in ("state", "conv")}
        for r, j in enumerate(pick):
            for k in staged:
                _rows(staged[k], axis)[r] = _rows(snaps[j][k], axis)[r]
    return torch.stack(logits, dim=1), cache, staged


def forward_chunk_paged(params: Params, cfg: ModelConfig,
                        tokens: torch.Tensor, pos: torch.Tensor,
                        block: torch.Tensor, cache: Params, *,
                        write_block=None, keep=None
                        ) -> Tuple[torch.Tensor, Params, dict]:
    """The chunk lane for the SSM family: C sequential per-token steps,
    bitwise :func:`decode_step_paged` called C times.  Returns (logits
    (B, C, V) float32, cache with the full chunk absorbed, staged); see
    :func:`chunk_steps` for ``staged`` and ``keep``."""
    del pos, block, write_block
    return chunk_steps(lambda tok, j: _step(params, cfg, tok, cache),
                       tokens, cache, keep, axis=1)


def chunk_stage(cfg: ModelConfig, cache: Params) -> Params:
    """A COPY of the rollback-able state (the decode steps that follow
    overwrite the cache in place)."""
    return {"state": cache["state"].clone(), "conv": cache["conv"].clone()}


def restore_stage(cfg: ModelConfig, cache: Params, stage: Params,
                  mask: torch.Tensor, axis: int = 1) -> Params:
    """Rows r < len(mask) where ``mask[r]``: the cache takes ``stage``'s
    state, in place."""
    b = mask.shape[0]
    for key in ("state", "conv"):
        dst = _rows(cache[key], axis)[:b]
        m = mask.reshape((b,) + (1,) * (dst.ndim - 1))
        dst.copy_(torch.where(m, _rows(stage[key], axis)[:b], dst))
    return cache


def select_stage(cfg: ModelConfig, staged: Params, keep: torch.Tensor,
                 axis: int = 1) -> Params:
    """Per row, the snapshot after exactly ``keep`` (B,) inputs:
    ``staged[keep - 1]`` (keep >= 1; masked out by the caller otherwise),
    leaves (C, L, B, ...) -> (L, B, ...)."""
    idx = torch.clamp(keep.long() - 1, min=0)
    out = {}
    for key in ("state", "conv"):
        a = staged[key]
        shape = [1] * a.ndim
        shape[axis + 1] = -1
        i = idx.reshape(shape).expand(1, *a.shape[1:])
        out[key] = torch.gather(a, 0, i)[0]
    return out
