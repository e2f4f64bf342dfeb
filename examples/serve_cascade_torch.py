"""End-to-end driver on the port: serve a small model with batched requests
through the HI cascade (the torch copy of ``examples/serve_cascade.py``).

Builds an S/L tier pair from an assigned architecture (reduced, as the
reference's; ``launch/serve.py --no-reduced`` serves the full config), feeds
batched requests through the batcher, and reports the paper's offload/cost accounting plus measured tier
latencies.  On the card by default; ``--device cpu`` runs on the CPU.

  PYTHONPATH=src python examples/serve_cascade_torch.py --arch qwen2-1.5b \
      --requests 32 --theta 0.55

``--stream`` serves the same request set through the continuous-batching
scheduler (slot-level admission over the paged KV pool) instead of drained
batches.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import HIConfig
from repro_torch.configs.registry import ARCHS
from repro_torch.core.baselines import TimingModel
from repro_torch.core.router import capacity_for
from repro_torch.models import model_zoo
from repro_torch.serving import engine as engine_mod
from repro_torch.serving.batcher import Batcher, Request
from repro_torch.serving.engine import KV_DTYPE, build_engine


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


@torch.inference_mode()
def _tier_ms_per_request(tier, batch, bucket, steps, cache_len, device,
                         iters: int = 3) -> float:
    """Wall ms per request for ONE tier's prefill + decode (the cascade runs
    both tiers in one call, so each tier is timed on its own)."""
    toks = torch.zeros((batch, bucket), dtype=torch.long, device=device)
    cache = model_zoo.init_cache(tier.cfg, batch, cache_len, KV_DTYPE, device)
    theta = torch.tensor(0.5, dtype=torch.float32, device=device)

    def once():
        engine_mod._generate(tier.params, tier.cfg, toks, cache, steps=steps,
                             metric="max_prob", theta=theta)
        _sync(device)

    once()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        once()
        times.append(time.perf_counter() - t0)
    return min(times) / batch * 1000


def main(arch: str = "qwen2-1.5b", requests: int = 24, batch: int = 8,
         theta: float = 0.55, capacity_factor: float = 0.5,
         max_new_tokens: int = 6, stream: bool = False,
         device: str = "cuda") -> dict:
    cfg = ARCHS[arch].reduced()
    hi = HIConfig(theta=theta, capacity_factor=capacity_factor)
    print(f"building HI cascade for {arch}: "
          f"S={cfg.s_variant(hi.s_scale).name} L={cfg.name}")
    engine = build_engine(cfg, hi, max_new_tokens=max_new_tokens,
                          cache_len=64, device=device)

    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(
        0, cfg.vocab_size, int(rng.integers(4, 16))).astype(np.int32),
        max_new_tokens=max_new_tokens) for i in range(requests)]

    t0 = time.time()
    buckets = []
    if stream:
        results = engine.serve_stream(reqs, buckets=(16, 32),
                                      num_slots=batch, page_size=16)
        confs = np.asarray([results[r.request_id]["confidence"]
                            for r in reqs])
        n_off = sum(results[r.request_id]["offloaded"] for r in reqs)
        print(f"stream: conf={np.round(confs, 2)} "
              f"offloaded={n_off}/{len(reqs)} "
              f"({int(engine.stats['stream_ticks'])} ticks, "
              f"{int(engine.stats['stream_compiles'])} scheduler)")
    else:
        batcher = Batcher(batch_size=batch, buckets=(16, 32))
        for r in reqs:
            batcher.submit(r)
        while batcher.queue:
            b = batcher.next_batch()
            out = engine.serve(b.tokens)
            buckets.append(b.tokens.shape[1])
            print(f"batch {len(buckets)}: "
                  f"conf={np.round(out['confidence'], 2)} "
                  f"offloaded={int(out['offloaded'].sum())}/{len(b.tokens)}")
    dt = time.time() - t0

    s = engine.summary()
    print(f"\nserved {s['requests']} requests in {dt:.1f}s")
    print(f"offload fraction: {s['offload_frac']:.1%}  "
          f"(capacity drops: {s['drop_frac']:.1%})")
    print(f"cascade wall time {s['serve_time']:.2f}s "
          f"({int(s['cache_allocs'])} cache shapes)")

    # paper Fig-8-style latency accounting with directly measured tier costs
    bucket = max(buckets) if buckets else 16
    cap = capacity_for(batch, capacity_factor)
    per_s = _tier_ms_per_request(engine.s, batch, bucket, max_new_tokens,
                                 engine.cache_len, device)
    per_l = _tier_ms_per_request(engine.l, cap, bucket, max_new_tokens,
                                 engine.cache_len, device)
    tm = TimingModel(t_local_ms=per_s, t_offload_ms=per_l)
    hi_ms = tm.hi_makespan_ms(s["requests"], int(s["offloaded"]))
    full_ms = s["requests"] * per_l
    print(f"measured per-request: S {per_s:.1f}ms, L {per_l:.1f}ms")
    print(f"HI makespan {hi_ms:.0f}ms vs full-offload {full_ms:.0f}ms "
          f"-> {(1 - hi_ms / full_ms):.1%} latency saving")
    return {"summary": s, "per_s_ms": per_s, "per_l_ms": per_l,
            "hi_ms": hi_ms, "full_ms": full_ms}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b", choices=sorted(ARCHS))
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--theta", type=float, default=0.55)
    ap.add_argument("--capacity-factor", type=float, default=0.5)
    ap.add_argument("--max-new-tokens", type=int, default=6)
    ap.add_argument("--stream", action="store_true",
                    help="continuous batching (paged KV pool) instead of "
                         "drained batches")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(a.arch, a.requests, a.batch, a.theta, a.capacity_factor,
         a.max_new_tokens, a.stream, a.device)
