"""HICascade: the paper's Figure-1 pipeline over classifiers.

    S-tier forward on every sample
      -> confidence (the hi_gate kernel or the plain metric)
      -> policy decision (offload iff conf < theta)
      -> static-capacity router gather
      -> L-tier forward on the complex batch
      -> scatter-merge

Everything stays on the samples' device: nothing here reads a value back
to the host.

Binary heads.  A single-logit head (the §5 dog filter) scores with the
sigmoid of :func:`confidence.binary_prob` on every device, with or without
``use_kernel``: ``hi_gate`` computes a softmax over the row, which is 1.0
for every row of one column.  (The reference routes such a head through its
Pallas kernel under ``use_kernel`` and gets that 1.0; ROADMAP Queue C.)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict

import torch

from repro_torch.configs.base import HIConfig
from repro_torch.core import router as R
from repro_torch.core.confidence import binary_prob
from repro_torch.core.confidence import confidence as _confidence
from repro_torch.kernels import ops

ApplyFn = Callable[[Any, torch.Tensor], torch.Tensor]   # (params, x) -> logits


@dataclass(frozen=True)
class HICascade:
    """S/L apply functions + the HI decision parameters."""

    s_apply: ApplyFn
    l_apply: ApplyFn
    hi: HIConfig
    use_kernel: bool = False

    def _confidence(self, s_logits: torch.Tensor) -> torch.Tensor:
        if s_logits.shape[-1] == 1:
            return binary_prob(s_logits)
        if self.use_kernel:
            # theta as a device tensor: the kernel reads it by pointer
            theta = torch.full((), self.hi.theta, dtype=torch.float32,
                               device=s_logits.device)
            return ops.hi_gate(s_logits.contiguous(), theta,
                               metric=self.hi.metric)[0]
        return _confidence(s_logits, self.hi.metric)

    def _decide(self, conf: torch.Tensor) -> torch.Tensor:
        if self.hi.binary_relevance:
            return conf >= self.hi.theta          # §5: positives are complex
        return conf < self.hi.theta               # §4: low confidence offloads

    def infer(self, s_params: Any, l_params: Any, x: torch.Tensor
              ) -> Dict[str, torch.Tensor]:
        """x: (N, ...) -> dict of predictions + offload accounting."""
        n = x.shape[0]
        cap = R.capacity_for(n, self.hi.capacity_factor)

        s_logits = self.s_apply(s_params, x)
        conf = self._confidence(s_logits)
        offload = self._decide(conf)
        decision = R.route(offload, conf, cap)

        x_complex = R.gather(x, decision)
        l_logits = self.l_apply(l_params, x_complex)

        s_pred = (s_logits.argmax(dim=-1) if s_logits.shape[-1] > 1
                  else conf >= 0.5).to(torch.int32)
        l_pred = l_logits.argmax(dim=-1)
        pred = R.scatter_merge(s_pred, l_pred.to(s_pred.dtype), decision)

        return {
            "pred": pred,
            "s_pred": s_pred,
            "conf": conf,
            "offload_mask": decision.offload_mask,
            "served_remote": decision.served_remote,
            "dropped": decision.dropped,
            "n_offloaded": decision.offload_mask.sum(dtype=torch.int32),
        }


def classifier_cascade(s_apply: ApplyFn, l_apply: ApplyFn, hi: HIConfig,
                       use_kernel: bool = False) -> HICascade:
    return HICascade(s_apply=s_apply, l_apply=l_apply, hi=hi,
                     use_kernel=use_kernel)
