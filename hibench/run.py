#!/usr/bin/env python3
"""Run one cell of the benchmark once.

    python3 hibench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for.  The cell (``BENCHMARK.json``'s ``workloads`` entry) names a
configuration (``hibench/configs/<config>.json``) and a traffic mix
(``hibench/traffic/<mix>.json``); its own settings are in
``hibench/cells/<cell>.json`` and each per-layer metric is read by
``hibench/metrics/<metric>.py``.

Set-up makes both tiers' weights on the card from the seed, builds the
port's HI engine around them and serves one short warm-up wave.  The
window then serves waves of requests through ``HIEngine.serve_stream``,
closed-loop: a wave is submitted at once, the next when the engine
returns, until ``--seconds`` have passed; the window is the whole waves it
ran.  ``--trace 1`` runs the window with the scheduler's telemetry on and
then one more wave under ``torch.profiler`` and the same wave again,
untraced, with the two paged attention kernels' work tallied; it
reports the per-layer metrics instead of the end-to-end ones.  After the
window the program's state is freed and a sample of its requests is held
to the plain reference (``hibench/check.py``).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each compared number with its limit,
which also close standard error.
"""
from __future__ import annotations

import time

T0 = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent
# run as a script, this folder leads sys.path: its module names (trace,
# check, ...) must not shadow the standard library's
if sys.path and Path(sys.path[0]).resolve() == BENCH:
    sys.path.pop(0)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
GIB = 2 ** 30


def _env() -> None:
    """Build and kernel caches at fixed paths inside the checkout; no
    library may pull in JAX."""
    cache = ROOT / ".hibench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def load_cell(workload: str, root: Path = ROOT) -> SimpleNamespace:
    """Everything the harness reads for one cell, found by name."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    config = next(c for c in bench["configs"] if c["name"] == entry["config"])
    bench_dir = root / "hibench"

    def applies(m):
        return workload in m.get("workloads", [workload])

    return SimpleNamespace(
        name=workload, chips=entry["chips"],
        config=json.loads((root / config["file"]).read_text()),
        traffic=json.loads(
            (bench_dir / "traffic" / f"{entry['traffic']}.json").read_text()),
        settings=json.loads(
            (bench_dir / "cells" / f"{workload}.json").read_text()),
        end_to_end=[m for m in bench["end_to_end"] if applies(m)],
        per_layer=[m for m in bench["per_layer"] if applies(m)],
        metrics_dir=bench_dir / "metrics")


def read_metric(path: Path, ctx) -> object:
    spec = importlib.util.spec_from_file_location(
        "hibench_metric_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def _request_rows(items, out, first_id, buckets, wave):
    rows = []
    from hibench.check import pad_to_bucket
    for i, it in enumerate(items):
        rec = out[first_id + i]
        rows.append({"id": first_id + i, "wave": wave, "prompt": it.prompt,
                     "prefix": it.prefix,
                     "bucket": pad_to_bucket(len(it.prompt), buckets),
                     "max_new": it.max_new_tokens,
                     "tokens": rec["tokens"], "s_tokens": rec["s_tokens"],
                     "confidence": float(rec["confidence"]),
                     "offloaded": bool(rec["offloaded"]),
                     "served_remote": bool(rec["served_remote"]),
                     "status": rec["status"], "ttft": float(rec["ttft"])})
    return rows


def _failed(row, max_new: int) -> bool:
    want = min(row["max_new"], max_new)
    return (row["status"] != "ok" or len(row["s_tokens"]) != want
            or len(row["tokens"]) != want
            or row["offloaded"] != row["served_remote"])


def end_to_end(rows, window_s: float, peak: int, setup_s: float) -> dict:
    """The end-to-end metrics of a window: final answers' tokens (the L
    tier's for escalated requests) over its seconds, the 95th percentile
    of every request's time to first token (linear interpolation), the
    allocator's peak and the set-up time."""
    import numpy as np
    return {"tokens_per_s": sum(len(r["tokens"]) for r in rows) / window_s,
            "ttft_p95_ms": 1e3 * float(np.percentile(
                [r["ttft"] for r in rows], 95)),
            "peak_mem_gib": peak / GIB, "setup_s": setup_s}


def power_limit() -> str:
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return res.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def execute(cell, seed: int, seconds: float, trace: bool, device: str,
            t0: float = None, extra: dict = None) -> dict:
    """One run of ``cell`` on ``device``; returns the result object.  The
    CPU tests call it at reduced sizes with ``device="cpu"``.  ``extra``
    (``control.py``) receives the window's requests, the sampled requests'
    confidence differences and, with ``extra["control"]`` set, the TF32
    control's readings on the same sample."""
    import torch

    from hibench import check, flops, program, weights
    from hibench.reference import dims as dims_mod
    from hibench.traffic.generator import Waves

    t0 = time.monotonic() if t0 is None else t0
    st, cfg = cell.settings, cell.config
    serving = cfg["serving"]
    serve_kw = dict(st["serve"])
    buckets = serve_kw["buckets"]
    max_new = st["max_new_tokens"]
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    l_dims = dims_mod.from_config(cfg)
    s_dims = dims_mod.s_tier(l_dims, serving["s_scale"])
    marks = [("start", t0)]

    def mark(name):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        marks.append((name, time.monotonic()))

    mark("imports")
    l_params, s_params = weights.make_tiers(seed, l_dims, s_dims, dev)
    mark("weights")
    engine = program.build_engine(l_dims, s_dims, serving, max_new,
                                  l_params, s_params)
    waves = Waves(cell.traffic, l_dims.vocab, st["wave_requests"], seed)
    theta = calibrate(engine, waves, st, serve_kw)
    mark("calibration")
    # warm-up: one short wave of other prompts, every request escalated so
    # that both tiers run every lane the window uses
    program.set_theta(engine, 2.0)
    program.serve_wave(engine, waves.warmup(), 0, serve_kw)
    program.set_theta(engine, theta)
    mark("warmup")
    setup_s = time.monotonic() - t0
    print("set-up: " + ", ".join(
        f"{b[0]} {b[1] - a[1]:.3f} s" for a, b in zip(marks, marks[1:])),
        file=sys.stderr)

    sched = program.scheduler(engine)
    ticks0 = sched.counters.ticks
    saved0 = sched.prefix_stats.get("tokens_saved", 0)
    tel = program.telemetry() if trace else None
    rows, wave, wave_s = [], 0, []
    t_start = time.monotonic()
    while True:
        items = waves.wave(wave)
        first = (wave + 1) * 100_000
        out = program.serve_wave(engine, items, first, serve_kw, tel)
        rows += _request_rows(items, out, first, buckets, wave)
        wave_s.append(time.monotonic() - t_start - sum(wave_s))
        wave += 1
        if time.monotonic() - t_start >= seconds:
            break
    window_s = time.monotonic() - t_start
    ticks = sched.counters.ticks - ticks0
    saved = sched.prefix_stats.get("tokens_saved", 0) - saved0

    summary, bounds = None, {}
    if trace:
        summary, bounds = _traced_wave(engine, waves, wave, serve_kw, dev)
    peak = (torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0)

    # the program's state goes before the reference runs
    program.free_state(engine)
    del engine, sched
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_check = time.monotonic()
    failed = sum(_failed(r, max_new) for r in rows)
    spec = st["check"]
    limits = spec["limits"]
    picked = check.sample([r for r in rows if not _failed(r, max_new)],
                          seed, spec)
    details = None if extra is None else []
    values = check.readings(picked, l_params, s_params, l_dims, s_dims,
                            theta, spec["flip_margin"], details=details)
    correct = failed == 0 and bool(limits) and check.judge(values, limits)
    check_s = time.monotonic() - t_check
    if extra is not None:
        extra["rows"] = rows
        extra["details"] = details
        if extra.get("control"):
            extra["control_details"] = []
            extra["control"] = check.readings(
                picked, l_params, s_params, l_dims, s_dims, theta,
                spec["flip_margin"], tf32_control=True,
                details=extra["control_details"])

    ctx = SimpleNamespace(
        window_s=window_s, ticks=ticks, requests=rows,
        phase_time=None if tel is None else tel.phase_time,
        prefix_saved=saved,
        prompt_admitted=sum(r["bucket"] * (1 + r["offloaded"]) for r in rows),
        model_flops=sum(
            flops.request_flops(s_dims, len(r["prompt"]), len(r["s_tokens"]))
            + (flops.request_flops(l_dims, len(r["prompt"]), len(r["tokens"]))
               if r["offloaded"] else 0.0) for r in rows),
        trace=summary, kernel_bounds=bounds)
    metrics = {}
    if trace:
        for m in cell.per_layer:
            v = read_metric(cell.metrics_dir / f"{m['name']}.py", ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        e2e = end_to_end(rows, window_s, peak, setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    result = {"correct": bool(correct), "attempted": len(rows),
              "failed": int(failed), "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                         "kind": (torch.cuda.get_device_name(dev)
                                  if dev.type == "cuda" else "cpu"),
                         "count": cell.chips, "memory_peak_bytes": int(peak)}}
    if summary is not None:
        result["device"].update(busy_s=summary["busy_s"],
                                window_s=summary["window_s"])
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["window"] = {"theta": theta, "waves": wave,
                        "wave_s": wave_s, "seconds": window_s, "ticks": ticks,
                        "offloaded": sum(r["offloaded"] for r in rows),
                        "sampled": len(picked), "check_s": check_s}
    result["window"]["readings"] = values
    result["checks"] = {k: {"value": values.get(k), "limit": limits[k]}
                        for k in sorted(limits)}
    return result


def calibrate(engine, waves, st: dict, serve_kw: dict) -> float:
    """The gate's theta for this run's model and traffic: the S tier alone
    (theta 0: nothing escalates) serves the requests of the first
    ``calibration_waves`` measured waves, and theta is the
    ``offload_share`` quantile of their confidences, so that the cell's
    share escalates on every seed.  Under random weights a request's
    confidence (its answer's mean ``max_prob``) lies within a few percent
    of every other's, and the seed's weights move them all by as much: a
    theta fixed across seeds escalates from a fifth to over half of the
    requests, and the seed would set the L tier's work.  The pass runs on a
    scheduler of its own (no prefix sharing), freed before the warm-up:
    the window starts with no trace of it."""
    import gc

    import numpy as np

    from hibench import program
    program.set_theta(engine, 0.0)
    kw = dict(serve_kw, prefix_sharing=False)
    confs = []
    for i in range(st["calibration_waves"]):
        out = program.serve_wave(engine, waves.wave(i), 900_000 + i * 1_000,
                                 kw)
        confs += [float(r["confidence"]) for r in out.values()]
    program.free_state(engine)
    gc.collect()
    return float(np.quantile(np.asarray(confs), st["offload_share"]))


def _traced_wave(engine, waves, wave, serve_kw, dev):
    """One more wave under the profiler, then the same wave again, untraced,
    with the kernels' work tallied, so that the traced wave holds no device
    operation of the benchmark's own: (trace summary, {kernel entry point:
    {seconds bound, device seconds, calls}})."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from hibench import flops, program
    from hibench import trace as tr

    tel = program.telemetry()
    clock = tr.Clock()
    items = waves.wave(wave)
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with clock.marker():
            pass
        with record_function("hibench.window"):
            program.serve_wave(engine, items, 10 ** 9 // 2, serve_kw, tel)
    summary = tr.summarize(prof.profiler.kineto_results.events(),
                           "hibench.window", clock, tr.tick_segments(tel))
    calls = {}
    with program.tally_kernels(calls):
        program.serve_wave(engine, items, 10 ** 9 // 2 + 100_000, serve_kw)
    bounds = {}
    for name, rows in calls.items():
        pairs = torch.stack([r[0] for r in rows]).cpu().tolist()
        kv = torch.stack([r[1] for r in rows]).cpu().tolist()
        bound = sum(flops.paged_call_bound(p, k, *r[2:])
                    for p, k, r in zip(pairs, kv, rows))
        kernel = program.PAGED_KERNELS[name]
        dev_s = sum(t for op, t in summary["op_s"].items() if kernel in op)
        bounds[name] = {"bound_s": bound, "device_s": dev_s,
                        "calls": len(rows)}
    return summary, bounds


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _env()
    cell = load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"hibench: cell {cell.name} needs {cell.chips} CUDA device(s), "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result = execute(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                     T0)
    result["device"]["power"] = power_limit()
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        print(f"hibench: the process loaded {loaded}", file=sys.stderr)
        return 4
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
