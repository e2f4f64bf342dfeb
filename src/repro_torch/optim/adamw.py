"""AdamW with optional bf16 moment storage, global-norm clipping and the
reference's schedule: the reference's ``optim/adamw.py`` over the port's
param trees (``repro_torch.tree``).

State mirrors the params: ``{"m": ..., "v": ..., "step": int32 scalar}``,
with ``v`` a ``{"vr", "vc"}`` pair of row and column statistics where the
second moment is factored (the Adafactor rule).  The update runs under
``torch.no_grad()`` in float32 and casts back with round-to-nearest-even,
as jax's ``astype`` does.  Unlike the reference, whose arrays are
immutable, :func:`apply_updates` writes the new params and moments IN
PLACE into the tensors it is given (a full-width step would otherwise hold
two copies of params and moments) and returns those same tensors.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.tree import leaves, tree_map

Params = Any
_F32 = torch.float32


def _factorable(shape) -> bool:
    """Factor the second moment for >=2D weights (Adafactor rule)."""
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def _is_factored(x) -> bool:
    return isinstance(x, dict) and set(x) == {"vr", "vc"}


def init_state(params: Params, cfg: TrainConfig) -> Dict[str, Any]:
    dt = torch.bfloat16 if cfg.bf16_state else _F32

    def zeros(p, dtype=dt, shape=None):
        return torch.zeros(p.shape if shape is None else shape, dtype=dtype,
                           device=p.device)

    def v_init(p):
        if cfg.factored_v and _factorable(p.shape):
            # row/col mean-square stats — O(rows+cols) instead of O(rows*cols)
            return {"vr": zeros(p, _F32, p.shape[:-1]),
                    "vc": zeros(p, _F32, p.shape[:-2] + p.shape[-1:])}
        return zeros(p)

    dev = leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(v_init, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def lr_schedule(cfg: TrainConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to 10% (float32, on ``step``'s
    device)."""
    s = torch.as_tensor(step).to(_F32)
    warm = torch.clamp((s + 1) / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((s - cfg.warmup_steps) /
                       max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.1 + 0.45 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * cos


def global_norm(tree: Params) -> torch.Tensor:
    sums = [torch.sum(torch.square(x.to(_F32))) for x in leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def clip_by_global_norm(grads: Params, max_norm: float
                        ) -> Tuple[Params, torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: (g.to(_F32) * scale).to(g.dtype), grads), norm


@torch.no_grad()
def apply_updates(params: Params, grads: Params, state: Dict[str, Any],
                  cfg: TrainConfig
                  ) -> Tuple[Params, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step.  Writes params, moments and step in place (see the
    module's note) and returns them with ``{"lr", "grad_norm"}``."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = state["step"]
    lr = lr_schedule(cfg, step)
    b1, b2, eps = cfg.adam_b1, cfg.adam_b2, cfg.adam_eps
    t = step.to(_F32) + 1
    c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=_F32, device=t.device), t)
    c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=_F32, device=t.device), t)

    def upd(v, p, g, m):
        g32 = g.to(_F32)
        m32 = b1 * m.to(_F32) + (1 - b1) * g32
        mh = m32 / c1
        if _is_factored(v):                           # factored second moment
            g2 = torch.square(g32) + eps * eps
            vr = b2 * v["vr"] + (1 - b2) * torch.mean(g2, dim=-1)
            vc = b2 * v["vc"] + (1 - b2) * torch.mean(g2, dim=-2)
            # rank-1 reconstruction: v ~ vr vc^T / mean(vr)
            denom = torch.clamp(torch.mean(vr, dim=-1, keepdim=True),
                                min=1e-30)
            vhat = (vr[..., None] * vc[..., None, :] / denom[..., None]) / c2
            delta = mh / (torch.sqrt(vhat) + eps)
            v["vr"].copy_(vr)
            v["vc"].copy_(vc)
        else:
            v32 = b2 * v.to(_F32) + (1 - b2) * torch.square(g32)
            delta = mh / (torch.sqrt(v32 / c2) + eps)
            v.copy_(v32)                               # rounds to v's dtype
        delta = delta + cfg.weight_decay * p.to(_F32)
        p.copy_(p.to(_F32) - lr * delta)
        m.copy_(m32)
        return None

    # v first: its factored {vr, vc} dicts are leaves where params, grads
    # and m hold plain tensors
    tree_map(upd, state["v"], params, grads, state["m"], is_leaf=_is_factored)
    step += 1
    return params, state, {"lr": lr, "grad_norm": gnorm}
