"""Paper §4 on the port: HI for CIFAR-10-style image classification, the
Table 1 study (the torch copy of ``examples/image_classification_hi.py``).

Trains the paper's two tiers on the synthetic CIFAR-10 stand-in with the
port's ``train_cnn``:
  S-ML: 5-layer tinyML CNN (paper: 62.58%, 0.45 MB quantised)
  L-ML: deeper CNN standing in for EfficientNet (paper: 95%)
then calibrates theta* by brute force (paper: 0.607), runs the HI cascade
through the hi_gate kernel + static-capacity router, and prints the
Table-1 cost comparison (no offload / full offload / HI) for a sweep of
beta.  On the card by default; ``--device cpu`` runs on the CPU.

  PYTHONPATH=src python examples/image_classification_hi_torch.py [--fast]
"""
import argparse

import numpy as np
import torch

from repro_torch.configs.base import HIConfig
from repro_torch.core import replay
from repro_torch.core.calibrate import brute_force_theta, p_histogram
from repro_torch.core.cascade import classifier_cascade
from repro_torch.core.cost import CostReport
from repro_torch.core.metrics import format_table, hi_report
from repro_torch.data import images
from repro_torch.models import cnn
from repro_torch.training.cnn_trainer import (accuracy, predict_logits,
                                              train_cnn)

FAST = dict(n_train=3000, n_val=1000, n_test=1000, epochs_s=2, epochs_l=2)


def train_tiers(n_train=8000, n_val=2000, n_test=2000, epochs_s=4, epochs_l=5,
                seed=0, device="cuda"):
    x_tr, y_tr = images.make_dataset(n_train, seed=seed)
    x_va, y_va = images.make_dataset(n_val, seed=seed + 1)
    x_te, y_te = images.make_dataset(n_test, seed=seed + 2)
    print(f"training S-ML ({cnn.SML_CIFAR.name}) ...")
    ps = train_cnn(cnn.SML_CIFAR, x_tr, y_tr, epochs=epochs_s, verbose=True,
                   device=device)
    print(f"training L-ML ({cnn.LML_CIFAR.name}) ...")
    pl = train_cnn(cnn.LML_CIFAR, x_tr, y_tr, epochs=epochs_l, verbose=True,
                   device=device)
    return (ps, pl), (x_va, y_va), (x_te, y_te)


def main(fast: bool = False, device: str = "cuda", **sizes) -> dict:
    kw = dict(FAST if fast else {}, **sizes)
    (ps, pl), (x_va, y_va), (x_te, y_te) = train_tiers(device=device, **kw)

    s_acc = accuracy(ps, cnn.SML_CIFAR, x_te, y_te)
    l_acc = accuracy(pl, cnn.LML_CIFAR, x_te, y_te)
    print(f"\nS-ML accuracy {s_acc:.2%} (paper 62.58%), "
          f"size {cnn.model_size_mb(ps):.2f} MB int8 (paper 0.45 MB)")
    print(f"L-ML accuracy {l_acc:.2%} (paper 95%)")

    # --- theta* calibration on validation (paper: brute force -> 0.607) ----
    beta = 0.5
    s_logits_va = predict_logits(ps, cnn.SML_CIFAR, x_va)
    e = np.exp(s_logits_va - s_logits_va.max(-1, keepdims=True))
    conf_va = (e / e.sum(-1, keepdims=True)).max(-1)
    s_ok_va = s_logits_va.argmax(-1) == y_va
    theta, _ = brute_force_theta(conf_va, s_ok_va, beta)
    print(f"calibrated theta* = {theta:.3f} at beta={beta} (paper: 0.607)")
    hist = p_histogram(conf_va, s_ok_va, bins=10)
    print("Fig.6-style p-histogram (correct/incorrect per conf bin):")
    for i in range(10):
        print(f"  p in [{hist['edges'][i]:.1f},{hist['edges'][i+1]:.1f}): "
              f"{hist['correct'][i]:5d} / {hist['incorrect'][i]:5d}")

    # --- HI cascade on the test set -----------------------------------------
    hi = HIConfig(theta=float(theta), beta=beta, capacity_factor=1.0)
    casc = classifier_cascade(
        lambda p, x: cnn.apply_cnn(p, cnn.SML_CIFAR, x),
        lambda p, x: cnn.apply_cnn(p, cnn.LML_CIFAR, x),
        hi, use_kernel=True)
    with torch.no_grad():
        out = casc.infer(ps, pl, torch.as_tensor(x_te).to(device))
    out = {k: v.cpu().numpy() for k, v in out.items()}

    rep_hi = hi_report(out["pred"], out["s_pred"], out["served_remote"],
                       out["offload_mask"], y_te, None, beta)
    n = len(y_te)
    s_pred = out["s_pred"]
    l_pred = predict_logits(pl, cnn.LML_CIFAR, x_te).argmax(-1)
    rep_no = CostReport("no-offload", n, 0, int((s_pred != y_te).sum()), 0,
                        beta)
    rep_full = CostReport("full-offload", n, n, 0,
                          int((l_pred != y_te).sum()), beta)
    print("\n=== Table 1 (synthetic-data reproduction, beta=0.5) ===")
    print(format_table([rep_no, rep_full, rep_hi]))

    print("\n=== Table 1 (paper's published counts, replayed exactly) ===")
    t = replay.table1(beta)
    print(format_table([t["no_offload"], t["full_offload"], t["hi"]]))

    print("\nrelative cost reduction vs full offload (ours vs paper):")
    sweep = {}
    for b in (0.25, 0.5, 0.75, 0.99):
        t = replay.table1(b)
        ours = (1 - (rep_hi.offloaded * b + rep_hi.misclassified) /
                (n * b + rep_full.misclassified)) * 100
        paper = (1 - t["hi"].cost / t["full_offload"].cost) * 100
        sweep[b] = (ours, paper)
        print(f"  beta={b:.2f}: ours {ours:5.1f}%   paper {paper:5.1f}%")
    return {"s_acc": s_acc, "l_acc": l_acc, "s_logits_va": s_logits_va,
            "y_va": y_va, "conf_va": conf_va, "theta": float(theta),
            "hist": hist, "cascade": out, "y_te": y_te, "l_pred": l_pred,
            "reports": (rep_no, rep_full, rep_hi), "sweep": sweep}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(a.fast, a.device)
