"""Serving CLI: batched requests through the HI cascade (drain path).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
      --requests 32 --batch 8 --theta 0.6

Runs on the card by default; ``--device cpu`` runs the plain versions of the
kernels on the CPU.  ``--no-reduced`` runs the full published config.  The
reference's ``--legacy`` (``serve_legacy``) is not ported yet.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs.base import HIConfig
from repro_torch.configs.registry import ARCHS
from repro_torch.serving.batcher import Batcher, Request
from repro_torch.serving.engine import build_engine


def run(arch: str, *, reduced: bool = True, requests: int = 32, batch: int = 8,
        theta: float = 0.6, capacity_factor: float = 0.5, seed: int = 0,
        max_new_tokens: int = 8, metric: str = "max_prob",
        device: str = "cuda"):
    cfg = ARCHS[arch]
    if reduced:
        cfg = cfg.reduced()
    hi = HIConfig(theta=theta, capacity_factor=capacity_factor, metric=metric)
    engine = build_engine(cfg, hi, seed=seed, max_new_tokens=max_new_tokens,
                          cache_len=64, device=device)

    rng = np.random.default_rng(seed)
    batcher = Batcher(batch_size=batch, buckets=(16, 32))
    for i in range(requests):
        plen = int(rng.integers(4, 16))
        batcher.submit(Request(i, rng.integers(
            0, cfg.vocab_size, plen).astype(np.int32)))

    t0 = time.perf_counter()
    served = 0
    while batcher.queue:
        b = batcher.next_batch()
        out = engine.serve(b.tokens)
        served += int((b.request_ids >= 0).sum())
        print(f"batch: offloaded {int(out['offloaded'].sum())}/{len(b.tokens)} "
              f"mean_conf {out['confidence'].mean():.3f}")
    dt = time.perf_counter() - t0
    s = engine.summary()
    print(f"served {served} requests in {dt:.1f}s "
          f"({served / max(dt, 1e-9):.1f} req/s) on {engine.device} | "
          f"offload_frac {s['offload_frac']:.2%} drop_frac "
          f"{s['drop_frac']:.2%} | cascade time {s['serve_time']:.2f}s, "
          f"{int(s['cache_allocs'])} cache allocations")
    return s


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="smoke-scale config (disable with --no-reduced)")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--theta", type=float, default=0.6)
    ap.add_argument("--capacity-factor", type=float, default=0.5)
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--metric", default="max_prob",
                    choices=["max_prob", "margin", "entropy"])
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: cuda)")
    args = ap.parse_args()
    run(args.arch, reduced=args.reduced, requests=args.requests,
        batch=args.batch, theta=args.theta,
        capacity_factor=args.capacity_factor,
        max_new_tokens=args.max_new_tokens, metric=args.metric,
        device=args.device)


if __name__ == "__main__":
    main()
