"""Dry run: count every (arch x shape x mesh) case on one rank of a
256- or 512-rank world, with no card.

The reference lowers and compiles each case for 512 forced host devices
and reads XLA's analyses.  Here each case runs once, eagerly, on ``meta``
tensors (``launch/specs.py``) inside a ``fake`` process group of 256 or
512 ranks (``launch/mesh.dryrun_world``), under the counters of
``launch/counting.py``: FLOPs, dot bytes, collective bytes per kind and a
high-water mark of live tensor bytes, with the H100 roofline of
``launch/roofline.py``.  It runs the same on the CPU and beside a card.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes --out results.json

``--jobs N`` runs the cases in N worker processes (each its own world);
the rows and the summary are those of a sequential run.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import time
import traceback
from concurrent.futures import ProcessPoolExecutor
from typing import List, Optional

import torch

from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import ARCHS, shape_applicable
from repro_torch.launch import counting
from repro_torch.launch import roofline as rl
from repro_torch.launch import specs as case_specs
from repro_torch.launch.mesh import dryrun_world, make_production_mesh
from repro_torch.models import model_zoo
from repro_torch.sharding.specs import flatten_with_path

VARIANTS = ("baseline", "zero_dp", "ep_dp", "lean_opt", "zero_lean",
            "ep_lean", "split_cache")


def param_counts(cfg):
    """(total, active) parameter counts from the meta tree (no alloc)."""
    total = expert = 0
    for path, leaf in flatten_with_path(model_zoo.init_params_spec(cfg)):
        total += leaf.numel()
        if "experts" in path:
            expert += leaf.numel()
    active = total - expert
    if cfg.num_experts:
        active += expert * cfg.experts_per_token / cfg.num_experts
    return total, active


def _params_dtype(args) -> torch.dtype:
    """The dtype of the case's weights: its first argument's first
    floating leaf."""
    return next(leaf.dtype for _, leaf in flatten_with_path(args[0])
                if leaf.is_floating_point())


def skip_reason(arch: str, shape_name: str, hi: bool = False) -> str:
    """Why the case is skipped ("" where it runs): the assignment's rule
    (``registry.shape_applicable``), and the HI case on decode shapes
    only."""
    ok, reason = shape_applicable(ARCHS[arch], SHAPES[shape_name])
    if not ok:
        return reason
    if hi and not SHAPES[shape_name].is_decode:
        return "HI cascade case runs serve_step only"
    return ""


def run_case(arch: str, shape_name: str, *, multi_pod: bool = False,
             verbose: bool = True, variant: str = "baseline",
             hi: bool = False, capacity_factor: float = 0.5) -> dict:
    cfg = ARCHS[arch]
    shape = SHAPES[shape_name]
    mesh_name = "multi" if multi_pod else "single"
    reason = skip_reason(arch, shape_name, hi)
    if reason:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": reason}

    with dryrun_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        chips = mesh.world
        t0 = time.perf_counter()
        if hi:
            fn, args, _, _ = case_specs.make_hi_decode_case(
                cfg, shape, mesh, capacity_factor=capacity_factor)
        else:
            fn, args, _, _ = case_specs.make_case(cfg, shape, mesh, variant)
        _, counts = counting.count(fn, args)
        trace_s = time.perf_counter() - t0

    total_p, active_p = param_counts(cfg)
    tokens = shape.global_batch * (1 if shape.is_decode else
                                   case_specs.text_len(cfg, shape))
    mf = rl.model_flops(active_p, tokens, shape.mode)
    coll = dict(counts.collectives)
    roof = rl.Roofline(
        arch=arch, shape=shape_name, mesh=mesh_name, chips=chips,
        hlo_flops=counts.flops, hlo_bytes=counts.dot_bytes,
        coll_bytes=float(sum(coll.values())), coll_breakdown=coll,
        model_flops=mf / chips, peak_memory_bytes=counts.peak_bytes,
        flop_per_s=rl.peak_flops(_params_dtype(args)))
    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "variant": variant, "hi": hi,
        "capacity_factor": capacity_factor if hi else None,
        "status": "ok", "chips": chips, "plan": fn.plan,
        "trace_s": round(trace_s, 2),
        "total_params": total_p, "active_params": active_p,
        "memory": {
            "argument_gb": counts.argument_bytes / 1e9,
            "output_gb": counts.output_bytes / 1e9,
            "peak_gb_per_device": counts.peak_bytes / 1e9,
        },
        "cost": {"loop_aware_flops_per_chip": roof.hlo_flops,
                 "loop_aware_dot_bytes_per_chip": roof.hlo_bytes},
        "collectives": coll,
        "roofline": roof.row(),
    }
    if verbose:
        print(f"[{arch} x {shape_name} x {mesh_name}] OK trace={trace_s:.1f}s "
              f"peak={result['memory']['peak_gb_per_device']:.2f}GB/dev "
              f"dominant={roof.dominant} "
              f"(c={roof.compute_s:.4f}s m={roof.memory_s:.4f}s "
              f"coll={roof.collective_s:.4f}s)")
        print("  plan:", fn.plan)
        print("  memory:", {k: f"{v:.2f}GB"
                            for k, v in result["memory"].items()})
        print("  per-chip: flops=%.3e dot_bytes=%.3e"
              % (roof.hlo_flops, roof.hlo_bytes))
        print("  collectives:", {k: f"{v/1e9:.2f}GB" for k, v in coll.items()
                                 if v})
    return result


def _run_reported(task) -> dict:
    """One case, an exception reported as its ``error`` row."""
    (arch, shape, mp, kw) = task
    try:
        return run_case(arch, shape, multi_pod=mp, **kw)
    except Exception as e:  # noqa: BLE001 — report, keep going
        traceback.print_exc()
        return {"arch": arch, "shape": shape,
                "mesh": "multi" if mp else "single",
                "status": "error", "error": repr(e)}


def _one_thread() -> None:
    torch.set_num_threads(1)


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--variant", default="baseline", choices=VARIANTS)
    ap.add_argument("--hi", action="store_true",
                    help="run the HI cascade serve_step (decode shapes)")
    ap.add_argument("--capacity-factor", type=float, default=0.5)
    ap.add_argument("--out", default=None)
    ap.add_argument("--jobs", type=int, default=1,
                    help="worker processes (cases run in parallel)")
    args = ap.parse_args(argv)

    archs = list(ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    kw = dict(variant=args.variant, hi=args.hi,
              capacity_factor=args.capacity_factor)
    tasks = [(arch, shape, mp, kw) for arch in archs for shape in shapes
             for mp in meshes]

    if args.jobs > 1:
        # the train cases, the longest, first
        order = sorted(range(len(tasks)),
                       key=lambda i: SHAPES[tasks[i][1]].mode != "train")
        with ProcessPoolExecutor(
                args.jobs, multiprocessing.get_context("spawn"),
                initializer=_one_thread) as pool:
            done = pool.map(_run_reported,
                            [tasks[i][:3] + (dict(kw, verbose=False),)
                             for i in order])
            results = [r for _, r in sorted(zip(order, done))]
        for r in results:
            print(f"[{r['arch']} x {r['shape']} x {r['mesh']}] "
                  f"{r['status']}", r.get("trace_s", ""),
                  r.get("plan", r.get("reason", r.get("error", ""))))
    else:
        results = [_run_reported(t) for t in tasks]
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"\ndry-run summary: {n_ok} ok, {n_skip} skipped, {n_err} errors "
          f"of {len(results)}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print("wrote", args.out)
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
