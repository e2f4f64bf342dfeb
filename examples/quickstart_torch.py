"""Quickstart on the port: the HI decision module in 30 lines (the torch
copy of ``examples/quickstart.py``).

Runs the fused hi_gate kernel over S-tier logits, routes complex samples
through the static-capacity router, and prints the paper's cost accounting.
On the card by default; ``--device cpu`` runs the kernel's plain version.

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core.calibrate import brute_force_theta
from repro_torch.core.cost import cost_closed_form
from repro_torch.core.router import capacity_for, route
from repro_torch.kernels import ops


def main(device: str = "cuda") -> dict:
    rng = np.random.default_rng(0)
    n, classes = 1000, 10

    # pretend S-tier logits: half the samples confidently right, half fuzzy
    easy = rng.normal(0, 1, (n // 2, classes)); easy[:, 0] += 6
    hard = rng.normal(0, 1, (n // 2, classes))
    logits = torch.as_tensor(np.concatenate([easy, hard]),
                             dtype=torch.float32).to(device)
    s_correct = np.concatenate([np.ones(n // 2, bool),
                                rng.random(n // 2) < 0.3])

    def gate(theta):
        t = torch.tensor(theta, dtype=torch.float32, device=device)
        return ops.hi_gate(logits, t)

    # 1) calibrate theta* offline (paper SS4: brute force on validation data)
    conf_np = gate(0.5)[0].cpu().numpy()
    theta, cost = brute_force_theta(conf_np, s_correct, beta=0.4)
    print(f"calibrated theta* = {theta:.3f} (min cost {cost:.0f})")

    # 2) fused gate kernel: confidence + prediction + offload decision
    conf, pred, offload = gate(float(theta))
    frac = float(offload.float().mean())
    print(f"offload fraction = {frac:.2%}")

    # 3) static-capacity router
    cap = capacity_for(n, 0.6)
    d = route(offload.bool(), conf, cap)
    served = d.served_remote.cpu().numpy()
    print(f"served remotely: {int(served.sum())}/{n} "
          f"(capacity {cap}, dropped {int(d.dropped)})")

    # 4) the paper's cost model
    n_off = int(served.sum())
    wrong_local = int((~s_correct & ~served).sum())
    total = cost_closed_form(n_off, wrong_local, 0, beta=0.4)
    print("total cost:", total)
    return {"logits": logits.cpu().numpy(), "s_correct": s_correct,
            "conf": conf_np, "theta": float(theta), "cost": float(cost),
            "offload_frac": frac, "served": served,
            "dropped": int(d.dropped), "total_cost": total}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
