"""Margin-aware comparison of greedy decisions between two implementations.

Parity across frameworks, or between the card and the CPU, is not bitwise:
sums run in another order.  Random-init logits often have their top two
entries within that noise, so a greedy token is compared only where the
reference's top1 - top2 logit margin exceeds the tolerance.

It sits in the package, not beside the tests, because ``chip_smoke.py``
uses it too and finds only ``src/`` on its path.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def decisive(ref_logits: np.ndarray, tol: float) -> np.ndarray:
    """(..., V) -> (...) bool: the reference's argmax is decided by more
    than ``tol``."""
    top2 = np.sort(np.asarray(ref_logits, np.float64), axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) > tol


def greedy_agreement(ref_logits: np.ndarray, got_logits: np.ndarray,
                     tol: float) -> Tuple[int, int]:
    """(decisive positions, of which the two argmaxes agree)."""
    mask = decisive(ref_logits, tol)
    same = np.argmax(ref_logits, -1) == np.argmax(got_logits, -1)
    return int(mask.sum()), int((same & mask).sum())


# the reference's int8 fidelity gate (``benchmarks/bench_serving.py``
# ``_teacher_forced_agreement`` as its kv-quant scenario calls it): 8 slots,
# 16 decode steps, 16-token prompts from numpy seed 1, pages of 8
GATE_SLOTS, GATE_STEPS, GATE_PROMPT, GATE_PAGE, GATE_SEED = 8, 16, 16, 8, 1


def int8_agreement(params, cfg, device="cpu") -> Tuple[int, int, float]:
    """The reference's int8 fidelity measure on the port: the gate's
    prompts prefilled into a bf16 and an int8 paged pool, then
    ``GATE_STEPS`` decode steps, both fed the bf16 argmax.  Returns (greedy
    decisions where the two argmaxes agree, decisions, max abs logit
    difference); decisions = GATE_SLOTS * (GATE_STEPS + 1) = 136."""
    import torch
    from repro_torch.models import model_zoo
    slots, steps, prompt = GATE_SLOTS, GATE_STEPS, GATE_PROMPT
    npg = (prompt + steps) // GATE_PAGE + 1
    rng = np.random.default_rng(GATE_SEED)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (slots, prompt)),
                           device=device)
    lens = torch.full((slots,), prompt, device=device)
    block = torch.arange(1, slots * npg + 1, dtype=torch.int32,
                         device=device).reshape(slots, npg)
    caches, logits = {}, {}
    for dt in (torch.bfloat16, torch.int8):
        cache = model_zoo.init_paged_cache(cfg, slots, slots * npg + 1,
                                           GATE_PAGE, dt, device)
        logits[dt], caches[dt] = model_zoo.prefill_paged(
            params, cfg, toks, lens, torch.arange(slots, device=device),
            block, cache)
    lg_b, lg_q = logits[torch.bfloat16], logits[torch.int8]
    match = int((lg_b.argmax(-1) == lg_q.argmax(-1)).sum())
    err = float((lg_b - lg_q).abs().max())
    pos = torch.full((slots,), prompt, device=device)
    for i in range(steps):
        tok = lg_b.argmax(-1)[:, None]
        lg_b, _ = model_zoo.decode_step_paged(params, cfg, tok, pos + i,
                                              block, caches[torch.bfloat16])
        lg_q, _ = model_zoo.decode_step_paged(params, cfg, tok, pos + i,
                                              block, caches[torch.int8])
        match += int((lg_b.argmax(-1) == lg_q.argmax(-1)).sum())
        err = max(err, float((lg_b - lg_q).abs().max()))
    return match, slots * (steps + 1), err


# paged_trace over int8 pools on the card against the CPU: logits within the
# family's limit (absolute), between the error measured on the card and the
# int8-vs-bf16 gap on the same trace; every level within 1, and at most 1 in
# 200 off by 1 (values within rounding noise of a half level); scale rows
# within rtol 5e-3
# (the MoE archs take qwen2's limit: their CPU int8-vs-bf16 gaps on the
# trace are 7.6e-2 (deepseek-moe-16b) and 1.5 (arctic-480b))
TRACE_LOGIT_TOL = {"qwen2-1.5b": 1.5e-2, "zamba2-2.7b": 4e-3,
                   "deepseek-moe-16b": 1.5e-2, "arctic-480b": 1.5e-2}
TRACE_LEVEL_FLIPS, TRACE_SCALE_RTOL = 1 / 200, 5e-3


def traces_close(got, ref, logit_tol: float) -> Tuple[float, int, float]:
    """Two int8 :func:`paged_trace` results against each other under the
    rule above; page 0, the null page that padded and redirected rows
    write in no fixed order, is left out.  Raises AssertionError; returns
    (max logit difference, levels off by 1, max relative scale
    difference)."""
    (lg, pool), (lr, rpool) = got, ref
    err = max(float(np.abs(a - b).max()) for a, b in zip(lg, lr))
    if not err <= logit_tol:
        raise AssertionError(f"logits differ by {err:.3g} (limit "
                             f"{logit_tol:g})")
    flips = 0
    for k in ("kp", "vp"):
        d = np.abs(pool[k][:, 1:].astype(np.int32)
                   - rpool[k][:, 1:].astype(np.int32))
        flips += int((d == 1).sum())
        if d.max() > 1 or (d == 1).sum() > TRACE_LEVEL_FLIPS * d.size:
            raise AssertionError(f"{k}: a level {d.max()} steps off, "
                                 f"{int((d == 1).sum())}/{d.size} off by 1")
    rel = max(float((np.abs(pool[k][:, 1:] - rpool[k][:, 1:])
                     / np.abs(rpool[k][:, 1:]).clip(1e-12)).max())
              for k in ("ks", "vs"))
    if not rel <= TRACE_SCALE_RTOL:
        raise AssertionError(f"scale rows differ by {rel:.3g} relative")
    return err, flips, rel


def paged_trace(params, cfg, dtype, device="cpu"):
    """A fixed run of the paged model API over one fresh pool of ``dtype``,
    inputs from numpy seed 0, so that two devices (or two pool dtypes) can
    be held against each other: a prefill of two prompts (16 and 11
    tokens, pages of 8), a copy-on-write of slot 1's part-filled page 1
    into page 13 (the slot writes the copy from then on), two decode steps,
    one 8-token chunk (each slot writes one page six or three times and
    crosses into the next) and two more decode steps.  Returns each call's
    logits as float32 numpy ((2, V), or (2, 8, V) for the chunk) and the
    pool's tensors as numpy (bf16 as float32)."""
    import torch
    from repro_torch.models import model_zoo
    rng = np.random.default_rng(0)
    v = cfg.vocab_size
    block = np.arange(1, 13, dtype=np.int32).reshape(2, 6)
    cache = model_zoo.init_paged_cache(cfg, 2, 14, 8, dtype, device)
    on = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
    lg, cache = model_zoo.prefill_paged(
        params, cfg, on(rng.integers(0, v, (2, 16))), on([16, 11]),
        on([0, 1]), on(block), cache)
    logits = [lg]
    model_zoo.cow_pages(cfg, cache, np.array([block[1, 1], 0], np.int32),
                        np.array([13, 0], np.int32))
    block[1, 1] = 13
    pos = np.array([16, 11])
    for n in (1, 1, 8, 1, 1):
        lg, cache, *_ = (model_zoo.decode_step_paged if n == 1 else
                         model_zoo.forward_chunk_paged)(
            params, cfg, on(rng.integers(0, v, (2, n))), on(pos), on(block),
            cache)
        logits.append(lg)
        pos = pos + n
    return ([x.float().cpu().numpy() for x in logits],
            {k: (x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy()
             for k, x in cache.items()})
