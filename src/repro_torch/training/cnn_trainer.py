"""Small supervised-training loop for the paper's CNN classifiers (§3–§5):
the reference's ``training/cnn_trainer.py``.

Used by the examples to train the S-ML / L-ML tiers on the synthetic CWRU /
CIFAR-10 stand-in datasets, on the card by default.  The schedule, the
AdamW settings and the epoch permutations (``np.random.default_rng(seed)``)
are the reference's; the init is ``cnn.init_cnn`` from a torch generator
seeded with ``seed``, so the numbers differ from jax's init
(``models/cnn.py``).
"""
from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.models import cnn
from repro_torch.optim import adamw
from repro_torch.tree import leaves, unflatten


def _loss_fn(params, cfg: cnn.CNNConfig, x: torch.Tensor,
             y: torch.Tensor) -> torch.Tensor:
    logits = cnn.apply_cnn(params, cfg, x)
    if cfg.num_classes == 1:
        y = y.to(torch.float32)
        p = logits[:, 0]
        return torch.mean(torch.clamp(p, min=0) - p * y +
                          torch.log1p(torch.exp(-torch.abs(p))))
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, y.long()[:, None])[:, 0]
    return torch.mean(logz - gold)


def _step(params, opt, cfg: cnn.CNNConfig, tcfg: TrainConfig,
          x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    flat = leaves(params)
    wrt = [p.detach().requires_grad_() for p in flat]
    with torch.enable_grad():
        loss = _loss_fn(unflatten(params, wrt), cfg, x, y)
        grads = torch.autograd.grad(loss, wrt)
    adamw.apply_updates(params, unflatten(params, list(grads)), opt, tcfg)
    return loss.detach()


def train_cnn(cfg: cnn.CNNConfig, x_train: np.ndarray, y_train: np.ndarray,
              *, epochs: int = 5, batch: int = 128, lr: float = 2e-3,
              seed: int = 0, verbose: bool = False,
              device="cuda") -> Dict:
    """Train from ``cnn.init_cnn`` (a generator seeded with ``seed``) and
    return the params, on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    params = cnn.init_cnn(gen, cfg, device=device)
    total_steps = epochs * max(1, len(x_train) // batch)
    tcfg = TrainConfig(lr=lr, warmup_steps=max(1, min(20, total_steps // 10)),
                       total_steps=total_steps,
                       weight_decay=0.01, bf16_state=False)
    opt = adamw.init_state(params, tcfg)
    xs = torch.as_tensor(x_train).to(device)
    ys = torch.as_tensor(y_train).to(device)

    n = len(x_train)
    order_rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    for ep in range(epochs):
        perm = torch.as_tensor(order_rng.permutation(n)).to(device)
        losses = []
        for i in range(0, n - batch + 1, batch):
            idx = perm[i:i + batch]
            losses.append(_step(params, opt, cfg, tcfg, xs[idx], ys[idx]))
        if verbose:
            print(f"  epoch {ep}: loss {torch.stack(losses).mean():.4f} "
                  f"({time.perf_counter() - t0:.0f}s)")
    return params


@torch.no_grad()
def predict_logits(params, cfg: cnn.CNNConfig, x: np.ndarray,
                   batch: int = 512) -> np.ndarray:
    dev = leaves(params)[0].device
    outs = []
    for i in range(0, len(x), batch):
        xb = torch.as_tensor(x[i:i + batch]).to(dev)
        outs.append(cnn.apply_cnn(params, cfg, xb).cpu().numpy())
    return np.concatenate(outs)


def accuracy(params, cfg: cnn.CNNConfig, x: np.ndarray, y: np.ndarray) -> float:
    logits = predict_logits(params, cfg, x)
    if cfg.num_classes == 1:
        pred = (logits[:, 0] > 0).astype(np.int32)
    else:
        pred = logits.argmax(-1)
    return float((pred == y).mean())
