"""Mixture-of-Experts decoder (deepseek-moe fine-grained, arctic
dense-residual), a copy of the reference's ``models/moe.py``, and its
dropless serving FFN.

Training and the forward pass keep the reference's capacity-bounded
scatter (:func:`moe_ffn`): each token picks its top-k experts, each expert
owns a static ``capacity`` slot buffer, and overflowing (token, choice)
pairs are dropped.  The drop policy is the reference's: slot positions
from a count in token order within each of the k choices plus the running
per-expert ``base`` of the choices before (the reference's loop over the
choices, here one count, :func:`route`), positions clamped to ``cap - 1``
with dropped rows adding zeros, and the top-k gates renormalised.  Ties in
the router's probabilities go to the lower expert index, as ``lax.top_k``
breaks them.  The routed FFN is three batched products over the
(E, cap, D) buffers (``torch.bmm``, as the reference's ``einsum``).  The
capacity factor of :func:`forward` is the reference's 1.25.

Serving (:func:`serving_ffn`, the FFN of every serving pass) drops nothing:
the router is :func:`route`'s, the pass's live tokens' pairs are sorted by
expert on the device, and every pair runs through its expert in the
grouped kernel (``kernels/grouped_ffn.py``); padded positions (a bucket's
tail, an empty chunk-lane row, a slot that does not decode) take no pair.
The outputs combine over the k choices by gate, and the shared experts
add.  No count is read back to the host.  Everything else (attention, the
caches, the page pools and their int8 write side) is the dense family's:
the serving functions are ``models/transformer.py``'s with this module's
FFN, as the reference's MoE scans reuse its ``layers``.

Expert parallelism (:func:`moe_ffn_sharded`, the reference's shard_map
dispatch) runs on each rank's local shards over ``torch.distributed``:
routing stays replicated and rank-local, each rank dispatches its tokens
to its own experts, and one all-reduce over ``model`` combines the expert
partial outputs.  :func:`moe_ffn_auto` picks it under an ambient mesh
(``sharding/act.py``) whose ``model`` axis divides the experts, when the
layer's experts are this rank's block of that layout.  A serving L tier
whose experts are split over a ``model`` axis wider than 1 keeps this
capacity dispatch, at ``SERVE_CAPACITY`` 2.0, where the capacity and slot
positions are exactly :func:`moe_ffn`'s, so the same (token, choice)
pairs drop.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import grouped_ffn, ops
from repro_torch.models import layers as L
from repro_torch.models import transformer
from repro_torch.models.transformer import layer_params, maybe_remat
from repro_torch.sharding import act

Params = Dict[str, Any]

FORWARD_CAPACITY = 1.25
SERVE_CAPACITY = 2.0


def moe_capacity(num_tokens: int, num_experts: int, k: int,
                 factor: float = 1.25) -> int:
    """Static per-expert slot count."""
    return max(1, int(math.ceil(num_tokens * k / num_experts * factor)))


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _ffn_params(gen: torch.Generator, cfg: ModelConfig) -> Params:
    n, d, e = cfg.num_layers, cfg.d_model, cfg.num_experts
    p = {"router": transformer._dense(gen, (n, d, e)),
         "experts": transformer.swiglu_params(gen, (n, e), d,
                                              cfg.d_ff_expert)}
    if cfg.num_shared_experts:
        p["shared"] = transformer.swiglu_params(
            gen, (n,), d, cfg.num_shared_experts * cfg.d_ff_expert)
    if cfg.moe_dense_residual:
        p["dense"] = transformer.swiglu_params(gen, (n,), d, cfg.d_ff)
    return p


def init_decoder(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Random float32 params in the reference's layout: per layer ``ln1``,
    ``attn``, ``ln2``, the float32 ``router`` (D, E), the stacked experts
    ``{"wi", "wg"}`` (L, E, D, F) and ``"wo"`` (L, E, F, D), ``"shared"``
    one SwiGLU of ``num_shared_experts * d_ff_expert`` and, for arctic,
    the dense residual ``"dense"``.  Each weight is drawn and scaled in
    place, so no stacked expert tensor is ever held twice."""
    return transformer.init_decoder(
        gen, cfg, functools.partial(_ffn_params, cfg=cfg))


# ---------------------------------------------------------------------------
# routed FFN
# ---------------------------------------------------------------------------

def top_k(lp: Params, cfg: ModelConfig, xf: torch.Tensor):
    """The router over tokens ``xf`` (T, D): softmax over the E experts,
    the top k in ``lax.top_k``'s order (descending, ties to the lower
    index), the gates renormalised.  Returns (gate (T, k), idx (T, k),
    probs (T, E))."""
    return grouped_ffn.top_k_plain(xf.float() @ lp["router"],
                                   cfg.experts_per_token)


def route(lp: Params, cfg: ModelConfig, xf: torch.Tensor, cap: int):
    """The router (:func:`top_k`) and the drop policy over tokens ``xf``
    (T, D).

    The reference walks the k choices in turn: a pair's slot is its count
    among the choice's earlier tokens of the same expert, plus the running
    per-expert ``base`` of the choices before.  That is one count over the
    (choice, token) pairs taken choice by choice, which is how it is
    computed here, with no host sync and a handful of launches.

    Returns (gate (T, k) renormalised, idx (T, k) expert ids, pos (T, k)
    slots clamped to ``cap - 1``, keep (T, k) bool: the pair got a slot,
    probs (T, E))."""
    e, k = lp["router"].shape[-1], cfg.experts_per_token
    t = xf.shape[0]
    gate, idx, probs = top_k(lp, cfg, xf)
    flat = idx.t().reshape(-1)                                # choice-major
    onehot = flat[:, None] == torch.arange(e, device=xf.device)
    pos = torch.gather(onehot.long().cumsum(0), 1, flat[:, None])[:, 0] - 1
    pos = pos.reshape(k, t).t()
    return gate, idx, torch.clamp(pos, max=cap - 1), pos < cap, probs


def moe_ffn(lp: Params, cfg: ModelConfig, x: torch.Tensor,
            capacity_factor: float = 1.25
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y (B, S, D), aux_loss).

    Scatter dispatch into (E, cap, D) expert buffers; no (T, E, cap)
    one-hot is formed.  Every kept pair owns its slot and a dropped pair
    adds a zero row at ``cap - 1``, so the buffers are exact in any order
    of the scatter's sums.  The outputs combine choice by choice, in the
    reference's order."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    t = b * s
    cap = moe_capacity(t, e, k, capacity_factor)
    xf = x.reshape(t, d)
    gate, idx, pos, keep, probs = route(lp, cfg, xf, cap)

    buf = x.new_zeros((e, cap, d))
    buf.index_put_((idx, pos), xf[:, None, :] * keep[..., None].to(x.dtype),
                   accumulate=True)

    ex = lp["experts"]
    h = F.silu(torch.bmm(buf, ex["wg"])) * torch.bmm(buf, ex["wi"])
    out = torch.bmm(h, ex["wo"])                              # (E, cap, D)

    w = (gate * keep).to(x.dtype)
    y = x.new_zeros((t, d))
    for j in range(k):
        y = y + out[idx[:, j], pos[:, j]] * w[:, j, None]
    y = y.reshape(b, s, d)

    # load-balancing aux loss (Switch-style)
    first = idx[:, :1] == torch.arange(e, device=x.device)
    aux = e * torch.sum(first.float().mean(0) * probs.mean(0))
    return y, aux


# ---------------------------------------------------------------------------
# expert parallelism over torch.distributed (the production dispatch)
# ---------------------------------------------------------------------------
#
# The scatter dispatch above counts slot positions over the whole token
# dim.  Here routing stays local to each rank: tokens stay on their
# ``data`` shard (replicated across ``model``), every (data, model) rank
# dispatches its local tokens to its local experts, and one all-reduce over
# ``model`` combines the expert partial outputs.

def route_local(lp: Params, cfg: ModelConfig, xf: torch.Tensor, cap: int,
                lo: int, e_local: int):
    """:func:`route` over all E experts, restricted to the local experts
    ``[lo, lo + e_local)``: slot positions count the local pairs only,
    which for a local expert is its whole count, so a local pair keeps
    its slot exactly when :func:`route` keeps it.  Returns (gate, lid
    (T, k) local expert ids, 0 for other ranks' pairs, pos, keep (T, k):
    local and kept, probs, idx (T, k) global expert ids)."""
    gate, idx, pos, keep, probs = route(lp, cfg, xf, cap)
    local = (idx >= lo) & (idx < lo + e_local)
    return (gate, torch.where(local, idx - lo, 0), pos, keep & local,
            probs, idx)


def _sharded_layout(lp: Params, cfg: ModelConfig, mesh) -> bool:
    """Whether the layer's experts are one rank's block of the sharded
    storage: E / model experts, each of d_ff_expert / data columns."""
    e = lp["router"].shape[-1]
    m, n = mesh.shape["model"], mesh.shape.get("data", 1)
    wg = lp["experts"]["wg"]
    return (e % m == 0 and wg.shape[0] * m == e
            and wg.shape[-1] * n == cfg.d_ff_expert)


def moe_ffn_sharded(lp: Params, cfg: ModelConfig, x: torch.Tensor,
                    capacity_factor: float, mesh
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's block of the reference's shard_map'd routed FFN.

    ``x`` (B_l, S, D) is this rank's ``data`` block of the tokens; the
    router (D, E) is whole; the experts are this rank's
    ``[m E/M, (m+1) E/M)`` with their hidden dim F sharded over ``data``
    (the reference's storage: ``wi``/``wg`` (E_l, D, F/N), ``wo``
    (E_l, F/N, D)).  Capacity comes from the local tokens.  The schedule
    moves the smaller operand across ``data``: tokens-move all-gathers the
    (E_l, cap, D) buffers, multiplies them by the F shards and
    reduce-scatters the partial outputs; weights-move all-gathers F.
    Returns (y (B_l, S, D), aux): ``y`` all-reduced over ``model``, the
    aux loss averaged over ``data``.  On a ``model``-only mesh (no
    ``data`` axis) with M = 1 this is :func:`moe_ffn` op for op."""
    import torch.distributed as dist
    if not _sharded_layout(lp, cfg, mesh):
        raise ValueError(
            f"experts {tuple(lp['experts']['wg'].shape)} are not one rank's "
            f"block of {lp['router'].shape[-1]} experts x d_ff_expert "
            f"{cfg.d_ff_expert} on mesh {dict(mesh.shape)}: expected "
            "(E / model, D, d_ff_expert / data)")
    b, s, d = x.shape
    e, k = lp["router"].shape[-1], cfg.experts_per_token
    n_model = mesh.shape["model"]
    n_data = mesh.shape.get("data", 1)
    e_local = e // n_model
    t = b * s
    cap = moe_capacity(t, e, k, capacity_factor)
    # the schedule: move the smaller operand across ``data``
    f = cfg.d_ff_expert
    weights_bytes = 3 * e_local * d * f * 2
    tokens_bytes = 2 * e_local * cap * n_data * d * 2
    tokens_move = tokens_bytes < weights_bytes

    xf = x.reshape(t, d)
    gate, lid, pos, keep, probs, idx = route_local(
        lp, cfg, xf, cap, mesh.coord("model") * e_local, e_local)
    buf = x.new_zeros((e_local, cap, d))
    buf.index_put_((lid, pos), xf[:, None, :] * keep[..., None].to(x.dtype),
                   accumulate=True)

    ex = lp["experts"]
    if n_data == 1:
        wg, wi, wo = ex["wg"], ex["wi"], ex["wo"]
    elif tokens_move:
        # the F-sharded weights stay; the token buffers travel
        dgroup = mesh.group("data")
        buf = act.all_gather_dim(buf, dgroup, 1)
        wg, wi, wo = ex["wg"], ex["wi"], ex["wo"]
    else:
        # small experts: gather full-F weights, tokens stay put
        dgroup = mesh.group("data")
        wg = act.all_gather_dim(ex["wg"], dgroup, 2)
        wi = act.all_gather_dim(ex["wi"], dgroup, 2)
        wo = act.all_gather_dim(ex["wo"], dgroup, 1)
    h = F.silu(torch.bmm(buf, wg)) * torch.bmm(buf, wi)
    out = torch.bmm(h, wo)                                    # (E_l, ., D)
    if n_data > 1 and tokens_move:
        out = act.reduce_scatter_dim(out, dgroup, 1)          # (E_l, cap, D)

    w = (gate * keep).to(x.dtype)
    y = x.new_zeros((t, d))
    for j in range(k):
        y = y + out[lid[:, j], pos[:, j]] * w[:, j, None]
    if n_model > 1:
        dist.all_reduce(y, group=mesh.group("model"))
    y = y.reshape(b, s, d)

    first = idx[:, :1] == torch.arange(e, device=x.device)
    aux = e * torch.sum(first.float().mean(0) * probs.mean(0))
    if n_data > 1:
        dist.all_reduce(aux, group=mesh.group("data"))
        aux = aux / n_data
    return y, aux


def moe_ffn_auto(lp: Params, cfg: ModelConfig, x: torch.Tensor,
                 capacity_factor: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The expert-parallel dispatch under an ambient mesh whose ``model``
    axis divides the expert count, whose ``data`` size divides the batch,
    and whose layout the layer's experts are stored in (whole experts on a
    mesh of more than one rank are computed locally); else the local
    scatter."""
    mesh = act.current_mesh()
    if (mesh is not None and "model" in mesh.shape
            and x.shape[0] % mesh.shape.get("data", 1) == 0
            and _sharded_layout(lp, cfg, mesh)):
        return moe_ffn_sharded(lp, cfg, x, capacity_factor, mesh)
    return moe_ffn(lp, cfg, x, capacity_factor)


def _ffn(lp: Params, cfg: ModelConfig, xn: torch.Tensor,
         capacity_factor: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layer's FFN: routed experts, plus the shared experts and
    arctic's dense residual where the layer has them."""
    y, aux = moe_ffn_auto(lp, cfg, xn, capacity_factor)
    if "shared" in lp:
        y = y + L.swiglu(lp["shared"], xn, "shared")
    if "dense" in lp:
        y = y + L.swiglu(lp["dense"], xn, "dense")
    return y, aux


def dropless_ffn(lp: Params, cfg: ModelConfig, x: torch.Tensor,
                 live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The routed experts over every live (token, choice) pair, with no
    capacity: x (B, S, D) -> (B, S, D).  ``live`` (B, S) bool marks the
    tokens that route (None: all); a dead token's output is zero.

    The router's logits go to ``ops.route_pairs``, which sorts the live
    pairs by expert on the device, stably, so each expert's run holds its
    pairs in token order; the grouped kernel runs every live pair through
    its expert and scales it by its gate.  The (T, k, D) outputs are then
    summed over the k choices."""
    b, s, d = x.shape
    k = cfg.experts_per_token
    t = b * s
    xf = x.reshape(t, d)
    gate, pairs, offsets = ops.route_pairs(
        xf.float() @ lp["router"], k,
        None if live is None else live.reshape(t))
    ex = lp["experts"]
    out = ops.grouped_swiglu(xf, pairs, offsets, ex["wg"], ex["wi"],
                             ex["wo"], gate, k)
    return out.view(t, k, d).sum(1).view(b, s, d)


def _sharded_experts(lp: Params, cfg: ModelConfig) -> bool:
    """Whether the layer's experts are split over an ambient ``model``
    axis wider than 1 (the expert-parallel capacity dispatch)."""
    mesh = act.current_mesh()
    return (mesh is not None and mesh.shape.get("model", 1) > 1
            and _sharded_layout(lp, cfg, mesh))


def serving_ffn(lp: Params, cfg: ModelConfig, xn: torch.Tensor,
                live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The FFN hook of ``transformer``'s serving functions: the dropless
    routed experts over the ``live`` tokens, plus the shared experts and
    arctic's dense residual; experts split over a ``model`` axis take the
    capacity dispatch at ``SERVE_CAPACITY``."""
    if _sharded_experts(lp, cfg):
        return _ffn(lp, cfg, xn, SERVE_CAPACITY)[0]
    y = dropless_ffn(lp, cfg, xn, live)
    if "shared" in lp:
        y = y + L.swiglu(lp["shared"], xn, "shared")
    if "dense" in lp:
        y = y + L.swiglu(lp["dense"], xn, "dense")
    return y


def _serving(live: Optional[torch.Tensor]):
    return serving_ffn if live is None else functools.partial(serving_ffn,
                                                              live=live)


def _block(lp: Params, cfg: ModelConfig, x: torch.Tensor, win: int,
           capacity_factor: float) -> Tuple[torch.Tensor, torch.Tensor]:
    x = x + L.attention_forward(
        lp["attn"], L.rmsnorm(lp["ln1"], x, cfg.norm_eps),
        num_heads=cfg.num_heads, num_kv=cfg.num_kv_heads,
        head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
        window=win)
    y, aux = _ffn(lp, cfg, L.rmsnorm(lp["ln2"], x, cfg.norm_eps),
                  capacity_factor)
    return x + y, aux


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            capacity_factor: float = FORWARD_CAPACITY, remat: bool = False,
            last_only: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (logits (B, S, V) float32, mean aux loss);
    ``remat`` checkpoints each layer; ``last_only`` projects the last
    position only (logits (B, 1, V))."""
    h = params["embed"][tokens]
    win = tokens.shape[1]
    block = maybe_remat(_block, remat)
    auxs = []
    for i in range(cfg.num_layers):
        h, aux = block(layer_params(params["layers"], i), cfg, h, win,
                       capacity_factor)
        auxs.append(aux)
    h = L.rmsnorm(params["final_norm"], h, cfg.norm_eps)
    if last_only:
        h = h[:, -1:]
    return L.lm_logits(h, params["lm_head"]), torch.stack(auxs).mean()


# ---------------------------------------------------------------------------
# contiguous cache (the drain path) and the paged pool (continuous serving):
# the dense family's functions with the dropless routed FFN.  The paged
# functions take ``live`` (the pass's (B, S) bool tokens that route; None:
# all); the drain path routes every position.
# ---------------------------------------------------------------------------

init_cache = transformer.init_cache
init_paged_cache = transformer.init_paged_cache


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            cache: Params):
    """The whole (B, S) prompt in one pass; returns (last-position logits
    (B, V), cache)."""
    return transformer.prefill(params, cfg, tokens, cache, ffn=serving_ffn)


def decode_step(params: Params, cfg: ModelConfig, token: torch.Tensor,
                cache: Params):
    return transformer.decode_step(params, cfg, token, cache,
                                   ffn=serving_ffn)


def prefill_paged(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  lengths: torch.Tensor, slots: torch.Tensor,
                  block_rows: torch.Tensor, cache: Params, *,
                  start: Optional[torch.Tensor] = None,
                  live: Optional[torch.Tensor] = None):
    """Paged batched admission over the (A, S_max) rows."""
    return transformer.prefill_paged(params, cfg, tokens, lengths, slots,
                                     block_rows, cache, start=start,
                                     ffn=_serving(live))


def decode_step_paged(params: Params, cfg: ModelConfig, token: torch.Tensor,
                      pos: torch.Tensor, block: torch.Tensor, cache: Params,
                      *, write_block: Optional[torch.Tensor] = None,
                      live: Optional[torch.Tensor] = None):
    return transformer.decode_step_paged(params, cfg, token, pos, block,
                                         cache, write_block=write_block,
                                         ffn=_serving(live))


def forward_chunk_paged(params: Params, cfg: ModelConfig,
                        tokens: torch.Tensor, pos: torch.Tensor,
                        block: torch.Tensor, cache: Params, *,
                        write_block: Optional[torch.Tensor] = None,
                        live: Optional[torch.Tensor] = None):
    """The chunk lane over (B, C) tokens.  Returns (logits (B, C, V),
    cache, {})."""
    return transformer.forward_chunk_paged(params, cfg, tokens, pos, block,
                                           cache, write_block=write_block,
                                           ffn=_serving(live))
