#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line):

1. device  — the card's name, count, and ``nvidia-smi`` name + power limit;
   no card is a failure.
2. build   — the CUDA kernels are built from ``src/repro_torch/csrc``
   (seconds, and ``ptxas -v`` register / shared-memory / spill lines).
3. kernels — each kernel against its plain PyTorch version at the shapes the
   main path gives it, with the tolerance stated, and timed with CUDA events
   beside its bound, its plain version and, where one exists, one PyTorch
   call that computes the same function.
4. serve   — the main path: ``HIEngine.serve`` on the full-width qwen2-1.5b
   cascade (L = qwen2-1.5b, S = its ``s_variant(4)``), random float32 params
   from a seeded ``torch.Generator``, bf16 KV cache; 16 requests through
   ``Batcher(8, buckets=(128, 512))``, then the last batch again with theta
   at its median confidence, so that both branches of the offload rule run.
   Asserts one host fetch per serve and the kernels' launch counts, checks
   the outputs, and holds the port on the card against the port on the CPU
   on a small input, teacher-forced.
5. trace   — one more serve under ``torch.profiler``: the device's time by
   kernel kind and its busy share of the serve's wall time (``--trace DIR``
   keeps the gzipped Chrome trace in DIR).
6. the ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
   ``{"ok": true, "device": {...}}``.

TF32 is off for matmuls and cuDNN throughout, so float32 stays float32.
Imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and float32
# outside the tensor cores (the kernels' arithmetic is float32 FMA).
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
L2_BYTES = 50 * 2 ** 20

# main-path settings (full-width serve phase)
ARCH = "qwen2-1.5b"
N_REQUESTS, BATCH, BUCKETS = 16, 8, (128, 512)
MAX_NEW, CACHE_LEN, THETA, CAPACITY = 16, 1024, 0.6, 0.5
DECODE_POS = 520            # a mid-generation position of the 512 bucket

# tolerances of kernel vs plain version (both float32 arithmetic; only the
# order of the sums differs)
CONF_ATOL, CONF_RTOL = 1e-5, 1e-4        # over 151,936 exp terms
ATT_ATOL = 1e-4                          # over <= 1,024 positions
SMALL_LOGIT_TOL = 5e-3                   # card vs CPU, small model, bf16 K/V


def log(*a):
    print(*a, flush=True)


def timed(fn, args_list, iters, warmup=5):
    """Mean ms per call over ``iters`` calls, cycling through ``args_list``
    (copies whose total exceeds the L2 cache, so each call reads cold HBM as
    the main path does)."""
    import torch
    for i in range(warmup):
        fn(*args_list[i % len(args_list)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*args_list[i % len(args_list)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def copies(make, nbytes):
    """Enough independent input sets to exceed the L2 cache twice over."""
    return [make() for _ in range(max(2, math.ceil(2 * L2_BYTES / nbytes)))]


def bound(nbytes, flops):
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_hi_gate(gen):
    import torch
    from repro_torch.kernels import hi_gate as hg
    c = 151_936                       # qwen2 vocabulary, float32 logits
    worst, rows = 0.0, []
    for n in (8, 4):
        for metric in ("max_prob", "margin", "entropy"):
            for dtype in (torch.float32, torch.bfloat16):
                x = (torch.randn((n, c), generator=gen, device="cuda") * 3)
                x[0, 7] = x[0, 4000] = x[0].max() + 2.0   # duplicated max
                x = x.to(dtype)
                conf_p, pred_p, _ = hg.hi_gate_plain(x, 0.0, metric)
                # a row exactly at theta
                theta = conf_p[1:2].reshape(()).clone()
                conf_k, pred_k, off_k = hg.hi_gate_cuda(x, theta, metric)
                torch.cuda.synchronize()
                err = (conf_k - conf_p).abs()
                if not bool((err <= CONF_ATOL + CONF_RTOL * conf_p.abs()).all()):
                    raise AssertionError(f"hi_gate {metric} n={n} {dtype}: "
                                         f"max err {err.max().item():.3e}")
                if not torch.equal(pred_k, pred_p) or int(pred_k[0]) != 7:
                    raise AssertionError(f"hi_gate {metric}: argmax differs")
                if metric == "margin" and float(conf_k[0]) != 0.0:
                    raise AssertionError("hi_gate margin: duplicated max != 0")
                if not torch.equal(off_k, (conf_k < theta).to(torch.int32)):
                    raise AssertionError("hi_gate: offload != conf < theta")
                worst = max(worst, err.max().item())
                rows.append((n, metric, str(dtype)[6:], err.max().item()))
    for r in rows:
        log(f"  hi_gate n={r[0]} C={c} {r[1]:8s} {r[2]:8s} max_abs_err "
            f"{r[3]:.2e} (tol {CONF_ATOL:g} + {CONF_RTOL:g}*|conf|)")

    # timing at the main path's S-tier shape: (8, 151936) f32, max_prob
    n = 8
    nbytes = n * c * 4
    sets = copies(lambda: (torch.randn((n, c), generator=gen, device="cuda"),),
                  nbytes)
    theta = torch.tensor(THETA, device="cuda")
    ms = timed(lambda x: hg.hi_gate_cuda(x, theta, "max_prob"), sets, 200)
    plain_ms = timed(lambda x: hg.hi_gate_plain(x, theta, "max_prob"), sets, 50)
    bound_ms, by = bound(nbytes + n * 12 + 4, 6 * n * c)
    log(f"  hi_gate (8, {c}) f32: {ms * 1e3:.1f} us  plain {plain_ms * 1e3:.1f}"
        f" us  bound {bound_ms * 1e3:.2f} us ({by})  library: no single call")
    return {"name": "hi_gate", "route": "cuda",
            "source": "src/repro_torch/csrc/hi_gate.cu",
            "replaces": "src/repro/kernels/hi_gate.py:69",
            "shape": f"logits ({n}, {c}) float32, max_prob",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": by, "library_ms": None}


def _attn_case(gen, b, h, k, d, s, valid, dtype):
    import torch
    q = torch.randn((b, 1, h, d), generator=gen, device="cuda")
    ck = torch.randn((b, s, k, d), generator=gen, device="cuda").to(dtype)
    cv = torch.randn((b, s, k, d), generator=gen, device="cuda").to(dtype)
    return q, ck, cv, valid


def check_decode_attention(gen):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as da
    s = CACHE_LEN
    kpos = torch.arange(s, device="cuda")
    upto = kpos <= DECODE_POS
    window = upto & (DECODE_POS - kpos < 256)
    cases = [  # (label, B, H, K, D, valid, cache dtype)
        ("L tier qwen2-1.5b", 4, 12, 2, 128, upto, torch.bfloat16),
        ("S tier qwen2-1.5b-s4", 8, 3, 1, 128, upto, torch.bfloat16),
        ("gemma3-1b window 256", 4, 4, 1, 256, window, torch.bfloat16),
        ("L tier, f32 cache", 4, 12, 2, 128, upto, torch.float32),
    ]
    worst, main = 0.0, None
    for label, b, h, k, d, valid, dtype in cases:
        args = _attn_case(gen, b, h, k, d, s, valid, dtype)
        out_k = da.decode_attention_cuda(*args)
        out_p = da.decode_attention_plain(*args)
        torch.cuda.synchronize()
        err = (out_k - out_p).abs().max().item()
        if not err <= ATT_ATOL or not bool(torch.isfinite(out_k).all()):
            raise AssertionError(f"decode_attention {label}: max err {err:.3e}")
        worst = max(worst, err)
        n_valid = int(valid.sum())
        isz = torch.tensor([], dtype=dtype).element_size()
        nbytes = (b * h * d * 4 * 2 + 2 * b * n_valid * k * d * isz + s)
        sets = copies(lambda: _attn_case(gen, b, h, k, d, s, valid, dtype),
                      2 * b * s * k * d * isz)
        ms = timed(da.decode_attention_cuda, sets, 200)
        plain_ms = timed(da.decode_attention_plain, sets, 50)
        # the library yardstick: one SDPA call on bf16 (B, H, 1, D) queries
        # over (B, K, S, D) K/V with the same mask; layouts made beforehand
        lib_sets = [(q.transpose(1, 2).to(dtype), ck.transpose(1, 2).contiguous(),
                     cv.transpose(1, 2).contiguous(), m[None, None, None, :])
                    for q, ck, cv, m in sets]
        lib_ms = timed(lambda q, kk, vv, m: F.scaled_dot_product_attention(
            q, kk, vv, attn_mask=m, enable_gqa=True), lib_sets, 200)
        bound_ms, by = bound(nbytes, 4 * b * h * n_valid * d)
        log(f"  decode_attention {label}: B={b} H={h} K={k} D={d} S={s} "
            f"valid={n_valid} {str(dtype)[6:]}  max_abs_err {err:.2e} (tol "
            f"{ATT_ATOL:g})  {ms * 1e3:.1f} us  plain {plain_ms * 1e3:.1f} us"
            f"  sdpa {lib_ms * 1e3:.1f} us  bound {bound_ms * 1e3:.2f} us "
            f"({by})")
        if main is None:
            main = {"name": "decode_attention", "route": "cuda",
                    "source": "src/repro_torch/csrc/decode_attention.cu",
                    "replaces": "src/repro/kernels/decode_attention.py:123",
                    "shape": (f"{label}: q ({b},1,{h},{d}) f32, K/V "
                              f"({b},{s},{k},{d}) bf16, {n_valid} valid"),
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": by, "library_ms": lib_ms}
    main["max_abs_err"] = worst
    return main


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def check_small_reference():
    """The port on the card against the port on the CPU (plain kernel
    versions), reduced qwen2-1.5b, prefill + 8 teacher-forced decode steps:
    logits allclose and every decisive greedy token equal."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models import model_zoo
    from repro_torch.parity import greedy_agreement
    cfg = ARCHS[ARCH].reduced()
    params = model_zoo.init_params(torch.Generator().manual_seed(1), cfg)
    rng = np.random.default_rng(1)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 24)))
    feed = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 8)))
    logs = {}
    for dev in ("cpu", "cuda"):
        p = _to(params, dev)
        cache = model_zoo.init_cache(cfg, 4, 64, device=dev)
        out, cache = model_zoo.prefill(p, cfg, prompt.to(dev), cache)
        steps = [out.cpu().numpy()]
        for i in range(feed.shape[1]):
            out, cache = model_zoo.decode_step(p, cfg, feed[:, i:i + 1].to(dev),
                                               cache)
            steps.append(out.cpu().numpy())
        logs[dev] = np.stack(steps)
    err = float(np.abs(logs["cuda"] - logs["cpu"]).max())
    n, agree = greedy_agreement(logs["cpu"], logs["cuda"], SMALL_LOGIT_TOL)
    log(f"  small input (reduced {ARCH}, card vs CPU, 9 steps): max logit err "
        f"{err:.2e} (tol {SMALL_LOGIT_TOL:g}); decisive tokens {agree}/{n}")
    if not err <= SMALL_LOGIT_TOL or n == 0 or agree != n:
        raise AssertionError("card and CPU disagree on the small input")


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


def serve_full_width():
    import numpy as np
    import torch
    from repro_torch.configs.base import HIConfig
    from repro_torch.configs.registry import ARCHS
    from repro_torch.kernels import ops
    from repro_torch.serving import engine as engine_mod
    from repro_torch.serving.batcher import Batcher, Request

    cfg = ARCHS[ARCH]
    hi = HIConfig(theta=THETA, capacity_factor=CAPACITY)
    t0 = time.perf_counter()
    eng = engine_mod.build_engine(cfg, hi, seed=0, cache_len=CACHE_LEN,
                                  max_new_tokens=MAX_NEW, device="cuda")
    torch.cuda.synchronize()
    n_params = {t: sum(v.numel() for v in _leaves(tier.params))
                for t, tier in (("L", eng.l), ("S", eng.s))}
    log(f"  built {cfg.name} L ({n_params['L'] / 1e9:.3f} B params, "
        f"{eng.l.cfg.num_layers} layers) + S {eng.s.cfg.name} "
        f"({n_params['S'] / 1e9:.3f} B, {eng.s.cfg.num_layers} layers) in "
        f"{time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(0)
    batcher = Batcher(batch_size=BATCH, buckets=BUCKETS)
    for i in range(N_REQUESTS):
        plen = int(rng.integers(32, 513))
        batcher.submit(Request(i, rng.integers(1, cfg.vocab_size, plen)
                               .astype(np.int32), max_new_tokens=MAX_NEW))

    fetches = []
    real_fetch = engine_mod._host_fetch

    def counting_fetch(tree):
        fetches.append(1)
        return real_fetch(tree)

    engine_mod._host_fetch = counting_fetch
    per_serve_decode = MAX_NEW * (eng.s.cfg.num_layers + eng.l.cfg.num_layers)
    per_serve_gate = 2 * MAX_NEW
    log(f"  expected launches per serve: decode_attention = T*(L_S + L_L) = "
        f"{MAX_NEW}*({eng.s.cfg.num_layers}+{eng.l.cfg.num_layers}) = "
        f"{per_serve_decode}; hi_gate = 2*T = {per_serve_gate}")
    torch.cuda.reset_peak_memory_stats()
    served = gen_tokens = 0
    t_serve = 0.0
    try:
        ops.reset_launch_counts()
        while batcher.queue:
            batch = batcher.next_batch()
            before = ops.launch_counts()
            n_fetch = len(fetches)
            t0 = time.perf_counter()
            out = eng.serve(batch.tokens)
            dt = time.perf_counter() - t0
            t_serve += dt
            after = ops.launch_counts()
            if len(fetches) - n_fetch != 1:
                raise AssertionError(f"serve made {len(fetches) - n_fetch} "
                                     "host fetches, expected 1")
            got = {k: after[k] - before[k] for k in after}
            if got != {"hi_gate": per_serve_gate,
                       "decode_attention": per_serve_decode}:
                raise AssertionError(f"launches per serve {got}")
            _check_outputs(out, batch, cfg, THETA)
            live = batch.request_ids >= 0
            served += int(live.sum())
            gen_tokens += int(live.sum()) * MAX_NEW
            log(f"  serve batch bucket={batch.bucket}: {dt * 1e3:.1f} ms, "
                f"offloaded {int(out['offloaded'].sum())}/{BATCH}, served "
                f"remote {int(out['served_remote'].sum())}, mean conf "
                f"{float(out['confidence'].mean()):.4f}")
        summary = eng.summary()
        # Random-init confidences all sit far below THETA, so every row
        # offloads.  Serve the last batch once more with theta between the
        # 4th and 5th smallest of its confidences, so that the rule keeps
        # rows local for their confidence too, not only for lack of room.
        conf = np.sort(out["confidence"])
        theta = float(np.float32((conf[BATCH // 2 - 1] + conf[BATCH // 2]) / 2))
        eng.hi = dataclasses.replace(eng.hi, theta=theta)
        before, n_fetch = ops.launch_counts(), len(fetches)
        out = eng.serve(batch.tokens)
        after = ops.launch_counts()
        got = {k: after[k] - before[k] for k in after}
        if got != {"hi_gate": per_serve_gate,
                   "decode_attention": per_serve_decode} or \
                len(fetches) - n_fetch != 1:
            raise AssertionError(f"launches per serve {got}, host fetches "
                                 f"{len(fetches) - n_fetch}")
        _check_outputs(out, batch, cfg, theta)
        n_off = int(out["offloaded"].sum())
        if n_off != BATCH // 2 or int(out["served_remote"].sum()) != n_off:
            raise AssertionError(f"theta {theta:.6f}: offloaded {n_off}, "
                                 f"served remote "
                                 f"{int(out['served_remote'].sum())}; "
                                 f"expected {BATCH // 2} and {BATCH // 2}")
        log(f"  serve again at theta {theta:.6f} (median confidence): "
            f"offloaded {n_off}/{BATCH}, all served remote, "
            f"{BATCH - n_off} kept local on confidence")
        eng.hi = dataclasses.replace(eng.hi, theta=THETA)
        launches = ops.launch_counts()
    finally:
        engine_mod._host_fetch = real_fetch
    peak = torch.cuda.max_memory_allocated()
    s = summary
    log(f"  served {served} requests in {t_serve:.3f} s: "
        f"{served / t_serve:.2f} req/s, {gen_tokens / t_serve:.1f} generated "
        f"tok/s; offload_frac {s['offload_frac']:.3f} drop_frac "
        f"{s['drop_frac']:.3f}; cache_allocs {s['cache_allocs']}; peak "
        f"max_memory_allocated {peak / 2 ** 30:.2f} GiB; host fetches "
        f"{len(fetches)}; launches {launches}")
    return launches, eng, batch.tokens


KERNEL_KINDS = (  # (kind, regex over the kernel's name), first match wins
    ("decode_attention", r"decode_attention_kernel"),
    ("hi_gate", r"hi_gate"),
    ("matmul (cuBLAS)", r"gemm|gemv|xmma|cutlass|nvjet|cublas|splitK"),
    ("other PyTorch kernels", r"."),
)


def trace_serve(eng, tokens, keep: Path | None):
    """One more serve of ``tokens`` under ``torch.profiler``: the device's
    kernel time by kind, and its busy share of the serve's host wall time.
    The gzipped Chrome trace is kept in ``keep`` if given."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = keep or Path(tmp)
        out_dir.mkdir(parents=True, exist_ok=True)
        _trace_serve(eng, tokens, out_dir / "serve_trace.json.gz")


def _trace_serve(eng, tokens, path: Path):
    import gzip
    import re
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    eng.serve(tokens)
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.serve(tokens)
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(str(path))
    with gzip.open(path, "rt") as f:
        events = json.load(f)["traceEvents"]
    kern = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy",
                                                  "gpu_memset")]
    if not kern:
        raise AssertionError("the trace holds no device activity")
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in kern)
    busy, end = 0.0, spans[0][0]
    for a, b in spans:            # union of the intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    by_kind, by_name = {}, {}
    for e in kern:
        kind = next(k for k, rx in KERNEL_KINDS if re.search(rx, e["name"]))
        for table, key in ((by_kind, kind), (by_name, e["name"])):
            n, t = table.get(key, (0, 0.0))
            table[key] = (n + 1, t + float(e["dur"]))
    total = sum(t for _, t in by_kind.values())
    log(f"  traced serve: {wall * 1e3:.1f} ms host wall under the profiler, "
        f"{plain_wall * 1e3:.1f} ms untraced just before; device busy "
        f"{busy / 1e3:.1f} ms = {busy / 1e3 / (wall * 1e3):.1%} of the traced "
        f"and {busy / 1e3 / (plain_wall * 1e3):.1%} of the untraced wall; "
        f"{len(kern)} device activities")
    for kind, (n, t) in sorted(by_kind.items(), key=lambda kv: -kv[1][1]):
        log(f"    {kind:24s} {n:6d} launches {t / 1e3:9.2f} ms "
            f"{t / total:6.1%} of device time")
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]:
        log(f"    {t / 1e3:9.2f} ms {n:6d}x  {name[:110]}")


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def _check_outputs(out, batch, cfg, theta):
    import numpy as np
    b = batch.tokens.shape[0]
    cap = max(1, min(b, int(round(b * CAPACITY))))
    if out["tokens"].shape != (b, MAX_NEW) or out["confidence"].shape != (b,):
        raise AssertionError(f"output shapes {out['tokens'].shape}")
    if not np.isfinite(out["confidence"]).all() or not (
            (out["confidence"] >= 0) & (out["confidence"] <= 1)).all():
        raise AssertionError("confidence not finite in [0, 1]")
    if not ((out["tokens"] >= 0) & (out["tokens"] < cfg.vocab_size)).all():
        raise AssertionError("token ids out of range")
    if not np.array_equal(out["offloaded"],
                          out["confidence"] < np.float32(theta)):
        raise AssertionError("offload != mean conf < theta")
    remote = out["served_remote"]
    if (remote & ~out["offloaded"]).any() or remote.sum() > cap or \
            remote.sum() != min(int(out["offloaded"].sum()), cap):
        raise AssertionError("router served a wrong set")
    if not np.array_equal(out["tokens"][~remote], out["s_tokens"][~remote]):
        raise AssertionError("local rows lost their S answer")


def main(argv=None) -> int:
    import argparse
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", type=Path, metavar="DIR",
                    help="keep the traced serve's gzipped Chrome trace in "
                         "DIR")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.serving.engine import disable_tf32

    disable_tf32()
    log("== device")
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"  {kind} x{count}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; nvidia-smi: {smi}")

    log("== build")
    info = build.build_info()
    log(f"  {info.path.name} built in {info.seconds:.1f} s")
    for ln in info.ptxas:
        log(f"  {ln}")

    log("== kernels vs plain versions")
    gen = torch.Generator(device="cuda").manual_seed(0)
    kernels = [check_hi_gate(gen), check_decode_attention(gen)]

    log("== serve (main path)")
    check_small_reference()
    launches, eng, tokens = serve_full_width()
    for k in kernels:
        k["launches"] = launches[k["name"]]
        if k["launches"] == 0:
            raise AssertionError(f"{k['name']} never launched on the main path")
    log("== trace (one more serve under torch.profiler)")
    trace_serve(eng, tokens, args.trace)

    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
