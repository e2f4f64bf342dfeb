"""Uniform model API of the port.  Only the dense decoder family is ported;
every other family raises ``NotImplementedError`` naming its ROADMAP item.

  init_params(gen, cfg)                        -> float32 params dict
  forward(params, cfg, tokens)                 -> logits (B, S, V) float32
  init_cache(cfg, batch, seq_len, dtype, device) -> decode cache dict
  prefill(params, cfg, tokens, cache)          -> (logits (B, V), cache)
  decode_step(params, cfg, token, cache)       -> (logits (B, V), cache)

The paged API of continuous serving (dense family, bf16 pages):

  init_paged_cache(cfg, slots, pages, page_size, dtype, device) -> pools
  prefill_paged(params, cfg, tokens, lengths, slots, block_rows, cache,
                start=None)                    -> (logits (A, V), cache)
  decode_step_paged(params, cfg, token, pos, block, cache, write_block=None)
  forward_chunk_paged(params, cfg, tokens, pos, block, cache,
                      write_block=None)        -> (logits (B, C, V), cache, {})
  cow_pages(cfg, cache, src, dst)              -> cache (copied in place)
  init_prefix_cache(cfg, entries, device)      -> {"logits": (E + 1, V)}

and the recurrent-state hooks the scheduler calls for every family
(``gather_chunk_slots`` ... ``snapshot_restore``), which pass through for
the dense family: its state is the pages.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np

import torch

from repro_torch.configs.base import (DENSE, ENCDEC, HYBRID, MOE, SSM, VLM,
                                      ModelConfig)
from repro_torch.kernels import ops
from repro_torch.models import transformer

Params = Dict[str, Any]

_NOT_PORTED = {
    SSM: "ROADMAP Queue A item 10 (SSM and hybrid families)",
    HYBRID: "ROADMAP Queue A item 10 (SSM and hybrid families)",
    MOE: "ROADMAP Queue A item 11 (MoE)",
    ENCDEC: "ROADMAP Queue A item 12 (the paper's own applications: "
            "enc-dec)",
    VLM: "ROADMAP Queue A item 12 (the paper's own applications: VLM)",
}


def _dense(cfg: ModelConfig) -> None:
    if cfg.family != DENSE:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: "
            f"{_NOT_PORTED.get(cfg.family, 'unknown family')}")


def init_params(gen: torch.Generator, cfg: ModelConfig) -> Params:
    _dense(cfg)
    return transformer.init_decoder(gen, cfg)


def forward(params: Params, cfg: ModelConfig,
            tokens: torch.Tensor) -> torch.Tensor:
    _dense(cfg)
    return transformer.forward(params, cfg, tokens)


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               dtype=torch.bfloat16, device="cuda") -> Params:
    _dense(cfg)
    return transformer.init_cache(cfg, batch, seq_len, dtype, device)


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            cache: Params):
    _dense(cfg)
    return transformer.prefill(params, cfg, tokens, cache)


def decode_step(params: Params, cfg: ModelConfig, token: torch.Tensor,
                cache: Params):
    _dense(cfg)
    return transformer.decode_step(params, cfg, token, cache)


# ---------------------------------------------------------------------------
# paged KV pool (continuous batching)
# ---------------------------------------------------------------------------

def init_paged_cache(cfg: ModelConfig, num_slots: int, num_pages: int,
                     page_size: int, dtype=torch.bfloat16, device="cuda"):
    _dense(cfg)
    return transformer.init_paged_cache(cfg, num_slots, num_pages, page_size,
                                        dtype, device)


def prefill_paged(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  lengths: torch.Tensor, slots: torch.Tensor,
                  block_rows: torch.Tensor, cache, *, start=None):
    """Admit a batch of requests in one pass (see
    ``transformer.prefill_paged``)."""
    _dense(cfg)
    return transformer.prefill_paged(params, cfg, tokens, lengths, slots,
                                     block_rows, cache, start=start)


def decode_step_paged(params: Params, cfg: ModelConfig, token: torch.Tensor,
                      pos: torch.Tensor, block: torch.Tensor, cache, *,
                      write_block=None):
    _dense(cfg)
    return transformer.decode_step_paged(params, cfg, token, pos, block,
                                         cache, write_block=write_block)


def forward_chunk_paged(params: Params, cfg: ModelConfig,
                        tokens: torch.Tensor, pos: torch.Tensor,
                        block: torch.Tensor, cache, *, write_block=None):
    _dense(cfg)
    return transformer.forward_chunk_paged(params, cfg, tokens, pos, block,
                                           cache, write_block=write_block)


def gather_chunk_slots(cfg: ModelConfig, cache, slots: torch.Tensor):
    """The chunk lane's W-row view of the cache: the dense state lives in the
    shared pages, routed by the lane's block rows, so the cache passes."""
    _dense(cfg)
    return cache


def scatter_chunk_slots(cfg: ModelConfig, cache, mini, stage_sel,
                        slots: torch.Tensor):
    """Merge the chunk lane back: the pages were written in place."""
    _dense(cfg)
    return mini


def chunk_stage(cfg: ModelConfig, cache):
    """The rollback-able recurrent state: none for the dense family."""
    _dense(cfg)
    return {}


def restore_stage(cfg: ModelConfig, cache, stage, mask: torch.Tensor):
    _dense(cfg)
    return cache


def select_stage(cfg: ModelConfig, staged, keep: torch.Tensor):
    _dense(cfg)
    return {}


def init_prefix_cache(cfg: ModelConfig, entries: int, device="cuda"):
    """Device-side prefix-cache rows: the last-prompt-position logits of
    each full-prompt entry, (entries + 1, V) float32.  Row ``entries`` is
    the drop row: the scheduler's sentinel saves (index ``entries``, the
    reference's ``mode="drop"``) land there and nothing reads it."""
    _dense(cfg)
    return {"logits": torch.zeros((entries + 1, cfg.vocab_size),
                                  dtype=torch.float32, device=device)}


def snapshot_save(cfg: ModelConfig, cache, prefix, rows: torch.Tensor,
                  slots: torch.Tensor):
    """Save admitted slots' recurrent state into prefix rows: none for the
    dense family (its prompt state is the retained pages; the scheduler
    saves the logits)."""
    _dense(cfg)
    return prefix


def snapshot_restore(cfg: ModelConfig, cache, prefix, rows: torch.Tensor,
                     slots: torch.Tensor):
    _dense(cfg)
    return cache


def cow_pages(cfg: ModelConfig, cache, src: np.ndarray, dst: np.ndarray):
    """Run the tick's copy-on-write page duplications in place: in every
    layer, pages ``dst`` become copies of pages ``src`` (host int arrays,
    padded with (0, 0) pairs).  K and V pools go through one
    ``ops.copy_pages`` call."""
    _dense(cfg)
    ops.copy_pages((cache["kp"], cache["vp"]), src, dst)
    return cache
