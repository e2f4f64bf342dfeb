"""Uniform model API of the port over every family of the reference: the
dense decoder (and the VLM's, with its patch prefix), MoE, SSM (mamba2),
hybrid (zamba2) and enc-dec (whisper).

  init_params(gen, cfg)                        -> float32 params dict
  init_params_spec(cfg, dtype=float32)         -> the same tree on ``meta``
  cache_spec(cfg, batch, seq_len)              -> init_cache's tree on ``meta``
  forward(params, cfg, tokens, patches=None, frames=None, remat=False,
          last_only=False)                     -> logits (B, S, V) float32
                                                  (VLM: (B, P + S, V);
                                                  last_only: (B, 1, V))
  loss(params, cfg, batch, remat=False)        -> (scalar, {"nll", "aux"})
  init_cache(cfg, batch, seq_len, dtype, device) -> decode cache dict
  prefill(params, cfg, tokens, cache)          -> (logits (B, V), cache)
  decode_step(params, cfg, token, cache)       -> (logits (B, V), cache)

``batch`` is the reference's dict: ``tokens`` and ``labels`` (B, S), and
``patches`` (B, P, D) for the VLM or ``frames`` (B, F, D) for the enc-dec
family.  ``remat`` checkpoints the activations at the reference's
granularity: each layer, each hybrid group.

The enc-dec family runs ``forward``, ``init_cache`` and ``decode_step``
(after ``whisper.precompute_cross``); ``prefill`` and the paged API refuse
it with the reference's ``ValueError``, as the reference serves no enc-dec
model.  The MoE forward's aux loss is ``moe.forward``'s second output.

The paged API of continuous serving (bf16, float32 or int8 pages; an int8
pool carries ``ks``/``vs`` scale rows, one per physical page and kv head):

  init_paged_cache(cfg, slots, pages, page_size, dtype, device) -> pools
  prefill_paged(params, cfg, tokens, lengths, slots, block_rows, cache,
                start=None, live=None)         -> (logits (A, V), cache)
  decode_step_paged(params, cfg, token, pos, block, cache, write_block=None,
                    live=None)
  forward_chunk_paged(params, cfg, tokens, pos, block, cache,
                      write_block=None, keep=None, live=None)
                                               -> (logits (B, C, V), cache,
                                                   staged)
  cow_pages(cfg, cache, src, dst)              -> cache (copied in place)
  init_prefix_cache(cfg, entries, device)      -> {"logits": (E + 1, V), ...}
  independent_rows(cfg, model_ranks=1)        -> whether a pass's rows are
                                                  computed apart

``live`` ((B, S) bool on the device) marks the positions of a pass that
hold a real token: the MoE family routes only those (a padded position
takes no expert work); the other families ignore it.

and the recurrent-state hooks the scheduler calls for every family
(``gather_chunk_slots`` ... ``snapshot_restore``, and ``draft_stage`` for
the speculative lane's rollback).  They pass through for
the attention families (dense, VLM, MoE), whose state is the pages; for the SSM and hybrid
families they move per-slot state rows.  Every hook updates the caches IN
PLACE, as the pages are: the scheduler's tick uses no return value but
the chunk lane's gathered rows.  Recurrent leaves carry a padding row past
the slots (index ``num_slots``) and the prefix cache a drop row (index
``entries``), where the scheduler's sentinel indices land.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np

import torch

from repro_torch.configs.base import (DENSE, ENCDEC, HYBRID, MOE, SSM, VLM,
                                      ModelConfig)
from repro_torch.kernels import ops
from repro_torch.models import hybrid, mamba2, moe, transformer, whisper

Params = Dict[str, Any]

_MODULES = {DENSE: transformer, VLM: transformer, MOE: moe, SSM: mamba2,
            HYBRID: hybrid, ENCDEC: whisper}
# slot axis of the recurrent leaves
_SLOT_AXIS = {SSM: 1, HYBRID: hybrid.AXIS}


def _module(cfg: ModelConfig):
    if cfg.family not in _MODULES:
        raise ValueError(cfg.family)
    return _MODULES[cfg.family]


def _served(cfg: ModelConfig, what: str):
    """The module of a family the serving API takes: not enc-dec, as in
    the reference."""
    if cfg.family == ENCDEC:
        raise ValueError(f"{what} not supported for family {cfg.family!r}")
    return _module(cfg)


def _recurrent(cfg: ModelConfig) -> bool:
    return cfg.family in _SLOT_AXIS


def independent_rows(cfg: ModelConfig, model_ranks: int = 1) -> bool:
    """Whether a serving pass computes each batch row on its own, so that
    dropping rows leaves the others' outputs as they were.  Every family's
    does, the MoE family's through its dropless dispatch, but for MoE
    experts split over ``model_ranks`` > 1, whose capacity dispatch sizes
    expert capacity from the pass's token count."""
    return cfg.family != MOE or model_ranks == 1


def _live(cfg: ModelConfig, live) -> Dict[str, Any]:
    """The ``live`` keyword of a MoE serving pass (the tokens that route);
    the other families compute every position alike."""
    return {"live": live} if cfg.family == MOE and live is not None else {}


def init_params(gen: torch.Generator, cfg: ModelConfig) -> Params:
    mod = _module(cfg)
    if mod in (transformer, moe):
        return mod.init_decoder(gen, cfg)
    return mod.init_model(gen, cfg)


class _MetaGenerator:
    """Stands in for a ``torch.Generator`` on the ``meta`` device (torch
    has none): the init functions then build shapes without storage."""
    device = torch.device("meta")


# leaves that stay float32 whatever the params' dtype, as in the reference
_FLOAT32_LEAVES = ("A_log", "D", "dt_bias", "router")


def _cast(tree: Params, dtype, name: str = ""):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype, k) for k, v in tree.items()}
    if not tree.is_floating_point() or name in _FLOAT32_LEAVES:
        return tree
    return tree.to(dtype)


def init_params_spec(cfg: ModelConfig, dtype=torch.float32) -> Params:
    """``init_params``' tree with the same leaf paths and shapes on the
    ``meta`` device: the partition rules and the dry run read the
    full-size configs without allocating them.  Floating leaves take
    ``dtype`` (``init_params``' float32 by default), but for the SSM
    decay terms and the MoE router, which stay float32 as in the
    reference."""
    return _cast(init_params(_MetaGenerator(), cfg), dtype)


def cache_spec(cfg: ModelConfig, batch: int, seq_len: int,
               dtype=torch.bfloat16) -> Params:
    """``init_cache``'s tree on the ``meta`` device."""
    return init_cache(cfg, batch, seq_len, dtype, "meta")


def forward_aux(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
                patches=None, frames=None, remat: bool = False,
                last_only: bool = False):
    """(logits, aux loss): the MoE family's mean router loss, a float32 0
    for every other family."""
    kw = dict(remat=remat, last_only=last_only)
    if cfg.family == MOE:
        return moe.forward(params, cfg, tokens, **kw)
    if cfg.family == VLM:
        logits = transformer.forward(params, cfg, tokens,
                                     patch_embeds=patches, **kw)
    elif cfg.family == ENCDEC:
        logits = whisper.forward(params, cfg, frames, tokens, **kw)
    else:
        logits = _module(cfg).forward(params, cfg, tokens, **kw)
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            patches=None, frames=None, remat: bool = False,
            last_only: bool = False) -> torch.Tensor:
    """Logits (B, S, V) float32: (B, P + S, V) for the VLM with ``patches``
    (B, P, D); the enc-dec family takes ``frames`` (B, F, D).
    ``last_only`` projects the last position only (the prefill serving
    path): (B, 1, V)."""
    return forward_aux(params, cfg, tokens, patches=patches, frames=frames,
                       remat=remat, last_only=last_only)[0]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits (B, S, V) float32, labels (B, S) -> mean NLL."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(logz - gold)


def loss(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], *,
         remat: bool = False):
    """(nll + ``router_aux_coef`` x aux, {"nll", "aux"}); the VLM's loss
    covers the text positions only."""
    logits, aux = forward_aux(params, cfg, batch["tokens"],
                              patches=batch.get("patches"),
                              frames=batch.get("frames"), remat=remat)
    labels = batch["labels"]
    if cfg.family == VLM:
        # logits cover [patches | text]; loss only on the text positions
        logits = logits[:, -labels.shape[1]:, :]
    nll = cross_entropy(logits, labels)
    total = nll + cfg.router_aux_coef * aux
    return total, {"nll": nll, "aux": aux}


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               dtype=torch.bfloat16, device="cuda") -> Params:
    return _module(cfg).init_cache(cfg, batch, seq_len, dtype, device)


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            cache: Params):
    return _served(cfg, "prefill").prefill(params, cfg, tokens, cache)


def decode_step(params: Params, cfg: ModelConfig, token: torch.Tensor,
                cache: Params):
    return _module(cfg).decode_step(params, cfg, token, cache)


# ---------------------------------------------------------------------------
# paged KV pool (continuous batching)
# ---------------------------------------------------------------------------

def init_paged_cache(cfg: ModelConfig, num_slots: int, num_pages: int,
                     page_size: int, dtype=torch.bfloat16, device="cuda"):
    return _served(cfg, "paged cache").init_paged_cache(
        cfg, num_slots, num_pages, page_size, dtype, device)


def prefill_paged(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  lengths: torch.Tensor, slots: torch.Tensor,
                  block_rows: torch.Tensor, cache, *, start=None, live=None):
    """Admit a batch of requests in one pass.  ``start`` (A,): the
    attention families splice cached prefix K/V below it; the recurrent
    families share whole prompts only (see each module)."""
    return _served(cfg, "prefill_paged").prefill_paged(
        params, cfg, tokens, lengths, slots, block_rows, cache, start=start,
        **_live(cfg, live))


def decode_step_paged(params: Params, cfg: ModelConfig, token: torch.Tensor,
                      pos: torch.Tensor, block: torch.Tensor, cache, *,
                      write_block=None, live=None):
    return _served(cfg, "decode_step_paged").decode_step_paged(
        params, cfg, token, pos, block, cache, write_block=write_block,
        **_live(cfg, live))


def forward_chunk_paged(params: Params, cfg: ModelConfig,
                        tokens: torch.Tensor, pos: torch.Tensor,
                        block: torch.Tensor, cache, *, write_block=None,
                        keep=None, live=None):
    """One multi-token paged pass: token i of slot b at ``pos[b] + i``.
    The attention families' ``staged`` is {}; the recurrent families' chunk is
    C per-token steps (bitwise the per-token path) and ``staged`` their
    boundary snapshots: all C of them, or with ``keep`` ((B,) host ints)
    only each row's snapshot after exactly ``keep`` inputs, which is
    ``select_stage(staged, keep)``."""
    mod = _served(cfg, "forward_chunk_paged")
    if not _recurrent(cfg):
        return mod.forward_chunk_paged(params, cfg, tokens, pos, block,
                                       cache, write_block=write_block,
                                       **_live(cfg, live))
    return mod.forward_chunk_paged(params, cfg, tokens, pos, block, cache,
                                   write_block=write_block, keep=keep)


def gather_chunk_slots(cfg: ModelConfig, cache, slots: torch.Tensor,
                       fresh=None):
    """The chunk lane's W-row view of the cache: the page pools and their
    scale rows pass (the lane's block rows route them; the scales are not
    staged for a rollback, as in the reference); recurrent rows are
    gathered (a copy; sentinel slots gather the padding row).  Rows where
    ``fresh`` (W,) bool is True start a prompt: their state is zero, as a
    prefill's."""
    if not _recurrent(cfg):
        return cache
    axis, idx = _SLOT_AXIS[cfg.family], slots.long()
    mini = dict(cache)
    for key in ("state", "conv"):
        rows = cache[key].index_select(axis, idx)
        if fresh is not None:
            shape = [1] * rows.ndim
            shape[axis] = -1
            rows = torch.where(fresh.reshape(shape), 0, rows)
        mini[key] = rows
    return mini


def scatter_chunk_slots(cfg: ModelConfig, cache, mini, stage_sel,
                        slots: torch.Tensor):
    """Merge the chunk lane back, in place: the pages and scale rows were
    written in place; recurrent rows take the selected boundary snapshot
    (``stage_sel``, exactly ``chunk_keep`` inputs absorbed) at ``slots``
    (sentinels land in the padding row)."""
    if not _recurrent(cfg):
        return cache
    return mamba2.copy_rows(cache, slots, stage_sel, None,
                            axis=_SLOT_AXIS[cfg.family])


def chunk_stage(cfg: ModelConfig, cache):
    """A copy of the rollback-able recurrent state: {} for the dense
    family, whose chunk state is positional."""
    if not _recurrent(cfg):
        return {}
    return mamba2.chunk_stage(cfg, cache)


def draft_stage(cfg: ModelConfig, cache, b: int):
    """A copy of rows [:b] of the recurrent state ({} for the dense
    family): the speculative lane's per-step snapshot, and the verify's
    pre-chunk state, from which ``restore_stage`` / ``select_stage``
    roll a slot back."""
    if not _recurrent(cfg):
        return {}
    return mamba2.snapshot_rows(cache, b, _SLOT_AXIS[cfg.family])


def restore_stage(cfg: ModelConfig, cache, stage, mask: torch.Tensor):
    """Slots where ``mask`` (B,) is True take ``stage``'s recurrent state,
    in place (a no-op for the dense family)."""
    if not _recurrent(cfg):
        return cache
    return mamba2.restore_stage(cfg, cache, stage, mask,
                                axis=_SLOT_AXIS[cfg.family])


def select_stage(cfg: ModelConfig, staged, keep: torch.Tensor):
    if not _recurrent(cfg):
        return {}
    return mamba2.select_stage(cfg, staged, keep,
                               axis=_SLOT_AXIS[cfg.family])


def init_prefix_cache(cfg: ModelConfig, entries: int, device="cuda",
                      dtype=torch.bfloat16):
    """Device-side prefix-cache rows: the last-prompt-position logits of
    each full-prompt entry, (entries + 1, V) float32, and for the recurrent
    families the state and conv rows at the prompt boundary.  Row
    ``entries`` is the drop row: the scheduler's sentinel saves (index
    ``entries``, the reference's ``mode="drop"``) land there and nothing
    reads it."""
    mod = _served(cfg, "prefix cache")
    base = {"logits": torch.zeros((entries + 1, cfg.vocab_size),
                                  dtype=torch.float32, device=device)}
    if _recurrent(cfg):
        base.update(mod.init_prefix_cache(cfg, entries, dtype, device))
    return base


def snapshot_save(cfg: ModelConfig, cache, prefix, rows: torch.Tensor,
                  slots: torch.Tensor):
    """Save admitted slots' recurrent state into prefix rows, in place:
    none for the dense family (its prompt state is the retained pages; the
    scheduler saves the logits)."""
    if not _recurrent(cfg):
        return prefix
    return _module(cfg).snapshot_save(cfg, cache, prefix, rows, slots)


def snapshot_restore(cfg: ModelConfig, cache, prefix, rows: torch.Tensor,
                     slots: torch.Tensor):
    if not _recurrent(cfg):
        return cache
    return _module(cfg).snapshot_restore(cfg, cache, prefix, rows, slots)


def cow_pages(cfg: ModelConfig, cache, src: np.ndarray, dst: np.ndarray):
    """Run the tick's copy-on-write page duplications in place: in every
    layer (group, for the hybrid), pages ``dst`` become copies of pages
    ``src`` (host int arrays, padded with (0, 0) pairs).  K and V pools, and
    an int8 pool's scale rows, which move with their pages, go through one
    ``ops.copy_pages`` call.  The SSM family has no pages."""
    if _served(cfg, "cow_pages") is mamba2:
        return cache
    ops.copy_pages(transformer.page_tensors(cache), src, dst)
    return cache
