"""Token-level HI: the cascade at block granularity inside one generation.

The port of the reference's ``serving/token_cascade.py``, over the port's
contiguous-cache model API (``model_zoo.prefill`` / ``decode_step``, with
``ops.hi_gate`` for the confidences: the hand-written kernels on the card,
their plain versions on the CPU).  The S tier drafts a block of k tokens
with per-token confidences; a block whose minimum confidence falls under
theta escalates to the L tier.  Accepted blocks cost only the S-tier draft;
escalated ones cost the L tier's work, the paper's cost split one level
down.

* :meth:`TokenCascade.generate`: the regeneration policy; an escalated
  block is drafted again by the L tier from its own state, and the S tier
  follows L's tokens.
* :meth:`TokenCascade.generate_speculative`: draft-verify; an escalated
  block gets one L pass over the drafted tokens, the longest prefix L
  agrees with is kept, the first divergence takes L's token (the bonus),
  and both tiers rewind to the accepted boundary.  This host-driven loop is
  the oracle of the scheduler's fused lane (``serve_stream(...,
  speculative=True)``): the same block decisions and the same tokens.

The caches are updated in place, so a rewind restores a copy taken before
the round (:func:`_copy`).  The loops read each block's decision on the
host; they are oracles, not the serving path.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.configs.base import HIConfig, ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import model_zoo
from repro_torch.serving import sampler


def _copy(cache: Dict[str, Any]) -> Dict[str, Any]:
    """A copy of a contiguous cache (tensors cloned, ``pos`` kept)."""
    return {k: v.clone() if isinstance(v, torch.Tensor) else v
            for k, v in cache.items()}


def _feed(params, cfg: ModelConfig, cache, tokens: torch.Tensor):
    """Catch a tier's cache up over ``tokens`` (B, K) by K decode steps;
    returns (cache, the last step's logits)."""
    logits = None
    for j in range(tokens.shape[1]):
        logits, cache = model_zoo.decode_step(params, cfg,
                                              tokens[:, j:j + 1], cache)
    return cache, logits


def _margin(logits: torch.Tensor) -> torch.Tensor:
    """Top1 - top2 logit, the margin a greedy choice was made by."""
    top = logits.topk(2, dim=-1).values
    return top[..., 0] - top[..., 1]


def _draft(params, cfg: ModelConfig, cache, logits, steps: int,
           metric: str, theta: torch.Tensor):
    """Greedy-draft ``steps`` tokens from ``logits``; returns (tokens
    (B, steps), confidences (steps, B), cache, last logits, the margin of
    each choice (B, steps))."""
    toks, confs, margins = [], [], []
    for _ in range(steps):
        tok = sampler.greedy(logits)
        confs.append(ops.hi_gate(logits, theta, metric)[0])
        margins.append(_margin(logits))
        logits, cache = model_zoo.decode_step(params, cfg, tok[:, None],
                                              cache)
        toks.append(tok)
    return (torch.stack(toks, dim=1), torch.stack(confs), cache, logits,
            torch.stack(margins, dim=1))


def _verify(params, cfg: ModelConfig, cache, logits, draft: torch.Tensor):
    """One verify pass over a drafted block: before feeding draft token j
    the tier's greedy choice for that position is recorded, so ``lv[:, j]``
    is what this tier would have emitted instead of ``draft[:, j]``.
    Returns (lv (B, K), cache caught up over the whole draft, logits, the
    margin of each choice (B, K))."""
    lvs, margins = [], []
    for j in range(draft.shape[1]):
        lvs.append(sampler.greedy(logits))
        margins.append(_margin(logits))
        logits, cache = model_zoo.decode_step(params, cfg,
                                              draft[:, j:j + 1], cache)
    return (torch.stack(lvs, dim=1), cache, logits,
            torch.stack(margins, dim=1))


@dataclass
class TokenCascade:
    """Block-granularity HI over one batched generation, on the device the
    params live on."""

    s_cfg: ModelConfig
    l_cfg: ModelConfig
    s_params: Any
    l_params: Any
    hi: HIConfig
    block: int = 4
    cache_len: int = 128

    def __post_init__(self):
        self.device = self.s_params["embed"].device
        self.theta = torch.full((), self.hi.theta, dtype=torch.float32,
                                device=self.device)
        self.stats = {"blocks": 0, "escalated": 0}

    def _prefill(self, params, cfg: ModelConfig, prompt: np.ndarray):
        cache = model_zoo.init_cache(cfg, prompt.shape[0], self.cache_len,
                                     device=self.device)
        tokens = torch.as_tensor(np.asarray(prompt), dtype=torch.int64,
                                 device=self.device)
        logits, cache = model_zoo.prefill(params, cfg, tokens, cache)
        return cache, logits

    def _s_draft(self, cache, logits):
        return _draft(self.s_params, self.s_cfg, cache, logits, self.block,
                      self.hi.metric, self.theta)

    def _escalates(self, confs: torch.Tensor) -> bool:
        return bool(float(confs.min()) < self.hi.theta)

    @torch.inference_mode()
    def generate(self, prompt: np.ndarray, num_blocks: int
                 ) -> Dict[str, Any]:
        """prompt: (B, P) -> dict(tokens (B, num_blocks * block), stats).

        The whole batch escalates a block together; per-request escalation
        is the sample-level router's job one level up."""
        s_cache, s_logits = self._prefill(self.s_params, self.s_cfg, prompt)
        l_cache, l_logits = self._prefill(self.l_params, self.l_cfg, prompt)
        out: List[np.ndarray] = []
        for _ in range(num_blocks):
            s_pre = _copy(s_cache)
            toks, confs, s_cache, s_next, _ = self._s_draft(s_cache,
                                                            s_logits)
            self.stats["blocks"] += 1
            if self._escalates(confs):
                # escalate: L drafts the block from ITS state, and S
                # follows L's tokens from its pre-draft state
                self.stats["escalated"] += 1
                toks, _, l_cache, l_logits, _ = _draft(
                    self.l_params, self.l_cfg, l_cache, l_logits, self.block,
                    self.hi.metric, self.theta)
                s_cache, s_logits = _feed(self.s_params, self.s_cfg, s_pre,
                                          toks)
            else:
                # accepted: L's cache catches up over the drafted block
                s_logits = s_next
                l_cache, l_logits = _feed(self.l_params, self.l_cfg,
                                          l_cache, toks)
            out.append(toks.cpu().numpy())
        return {
            "tokens": np.concatenate(out, axis=1).astype(np.int32),
            "blocks": self.stats["blocks"],
            "escalated": self.stats["escalated"],
            "escalation_frac": self.stats["escalated"]
            / max(self.stats["blocks"], 1),
        }

    @torch.inference_mode()
    def generate_speculative(self, prompt: np.ndarray, max_new: int
                             ) -> Dict[str, Any]:
        """Draft-verify, host-driven: the scheduler's fused lane's oracle.
        ``prompt``: (1, P), one sequence (the accepted prefix length is
        per-sequence data, which this loop resolves by rewinding).
        Greedy-only.

        A round is one scheduler tick for one slot: token 0 is the prompt's
        greedy continuation (the admission token, always emitted); each
        round drafts ``block`` tokens; a round whose minimum confidence
        clears theta is accepted whole; otherwise one L verify pass
        re-derives each position, the longest prefix L agrees with is kept,
        the first divergence emits L's token, and both tiers rewind to the
        pre-round caches and take the emitted tokens again.

        Returns dict(tokens (1, <= max_new), rounds [(escalated, n_emit)],
        blocks, escalated, accept_rate, margins): ``margins`` holds, per
        emitted token, the top1 - top2 logit margin its choice was made by
        (S's for the admission token and an accepted block's drafts, the
        smaller of S's and L's in an escalated block), so a comparison can
        count only the decisive positions."""
        if prompt.shape[0] != 1:
            raise ValueError("generate_speculative runs one sequence "
                             "(B = 1); batch speculation is the scheduler's")
        k = self.block
        s_cache, s_logits = self._prefill(self.s_params, self.s_cfg, prompt)
        l_cache, l_logits = self._prefill(self.l_params, self.l_cfg, prompt)
        tok0 = sampler.greedy(s_logits)                  # admission token
        emitted: List[int] = [int(tok0[0])]
        margins: List[float] = [float(_margin(s_logits)[0])]
        s_cache, s_logits = _feed(self.s_params, self.s_cfg, s_cache,
                                  tok0[:, None])
        l_cache, l_logits = _feed(self.l_params, self.l_cfg, l_cache,
                                  tok0[:, None])
        rounds: List[Tuple[bool, int]] = []
        drafted = accepted = 0
        while len(emitted) < max_new:
            s_pre, l_pre = _copy(s_cache), _copy(l_cache)
            toks, confs, s_cache, s_next, s_marg = self._s_draft(s_cache,
                                                                 s_logits)
            drafted += k
            esc = self._escalates(confs)
            lv, l_cache, l_next, l_marg = _verify(
                self.l_params, self.l_cfg, l_cache, l_logits, toks)
            marg = (torch.minimum(s_marg, l_marg) if esc else s_marg)[0]
            if not esc:
                # accepted at S-tier cost; the verify doubles as catch-up
                s_logits, l_logits = s_next, l_next
                out_toks, n = toks, k
                accepted += k
            else:
                mism = np.flatnonzero(lv[0].cpu().numpy()
                                      != toks[0].cpu().numpy())
                m = int(mism[0]) if len(mism) else k
                accepted += m
                if m == k:                     # L agrees with every draft
                    s_logits, l_logits = s_next, l_next
                    out_toks, n = toks, k
                else:
                    # keep the agreed prefix and L's correction; rewind both
                    # tiers and take the kept tokens again
                    out_toks = torch.cat([toks[:, :m], lv[:, m:m + 1]], dim=1)
                    n = m + 1
                    s_cache, s_logits = _feed(self.s_params, self.s_cfg,
                                              s_pre, out_toks)
                    l_cache, l_logits = _feed(self.l_params, self.l_cfg,
                                              l_pre, out_toks)
            rounds.append((esc, n))
            self.stats["blocks"] += 1
            if esc:
                self.stats["escalated"] += 1
            emitted.extend(int(t) for t in out_toks[0].cpu().numpy())
            margins.extend(marg[:n].cpu().tolist())
        return {
            "tokens": np.asarray(emitted[:max_new], np.int32)[None, :],
            "rounds": rounds,
            "blocks": len(rounds),
            "escalated": sum(1 for e, _ in rounds if e),
            "accept_rate": accepted / max(drafted, 1),
            "margins": np.asarray(margins[:max_new], np.float32),
        }


def build_token_cascade(cfg: ModelConfig, hi: HIConfig, *, seed: int = 0,
                        block: int = 4, cache_len: int = 64,
                        device: str = "cuda") -> TokenCascade:
    """A token cascade for one architecture: L = ``cfg``, S = its
    ``s_variant``, random params from a seeded ``torch.Generator`` on
    ``device`` (the card unless the CPU is asked for)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA device "
                           "is available")
    gen = torch.Generator(device=dev).manual_seed(seed)
    s_cfg = cfg.s_variant(hi.s_scale)
    l_params = model_zoo.init_params(gen, cfg)
    s_params = model_zoo.init_params(gen, s_cfg)
    return TokenCascade(s_cfg=s_cfg, l_cfg=cfg, s_params=s_params,
                        l_params=l_params, hi=hi, block=block,
                        cache_len=cache_len)
