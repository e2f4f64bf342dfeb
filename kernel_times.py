#!/usr/bin/env python3
"""Times the port's hi_gate and copy_pages wrappers on the card, for one tree.

    python3 kernel_times.py [--src DIR]

``DIR`` (default: this checkout's ``src``) holds the ``repro_torch`` package
to time, so that two trees, say a parent commit unpacked beside this one,
are compared on one card in one call: run it for each, in turns (parent,
change, change, parent).  It uses ``chip_smoke.py``'s inputs and timers:
for hi_gate, float32 logits at ``chip_smoke.GATE_SHAPES``, CUDA events over
200 calls, the profiler's device time and a CUDA-graph replay; for
copy_pages, ``chip_smoke.check_copy_pages`` over bf16 and int8 pools (its
log line: CUDA events, device time, the wrapper's host time, and
``index_copy_`` in the same process).  Prints one JSON line per hi_gate
shape.  Needs a card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src",
                    help="the directory that holds the repro_torch package")
    args = ap.parse_args(argv)
    # the package under test first: chip_smoke's own path entry, added
    # when it is imported, then no longer decides which one is used
    sys.path.insert(0, str(args.src.resolve()))
    import repro_torch
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import hi_gate as hg
    from repro_torch.serving.engine import disable_tf32

    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 1
    disable_tf32()
    cs.log(f"== {Path(repro_torch.__file__).parent}: "
           f"{torch.cuda.get_device_name(0)}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    theta = torch.tensor(cs.THETA, device="cuda")

    def gate(x):
        return hg.hi_gate_cuda(x, theta, "max_prob")

    for label, n, c in cs.GATE_SHAPES:
        _, times = cs.gate_times(gate, gen, n, c)
        print(json.dumps({"kernel": "hi_gate", "shape": [n, c],
                          "label": label, **times}), flush=True)
    cs.check_copy_pages(gen)
    cs.check_copy_pages(gen, quant=True)
    host_breakdown(gen)
    return 0


def _per_call_us(fn, iters=2000):
    import time
    for _ in range(20):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e6


def host_breakdown(gen):
    """The host's time per call of copy_pages' wrapper and of its pieces,
    at a tick's shape (qwen2-1.5b's L-tier pools, 8 pair slots of which 2
    are real): what the submitting thread spends, not the card."""
    import numpy as np
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import copy_pages as cp
    shape = (28, 393, 16, 2, 128)
    for label, pools in (
            ("bf16", [torch.zeros(shape, dtype=torch.bfloat16, device="cuda")
                      for _ in range(2)]),
            ("int8", [torch.zeros(shape, dtype=torch.int8, device="cuda")
                      for _ in range(2)]
             + [torch.zeros(shape[:2] + (2,), device="cuda")
                for _ in range(2)])):
        src = np.array([5, 0, 9, 0, 0, 0, 0, 0], np.int32)
        dst = np.array([7, 0, 11, 0, 0, 0, 0, 0], np.int32)
        row = {"kernel": "copy_pages host", "pools": label,
               "wrapper_us": _per_call_us(
                   lambda: cp.copy_pages_cuda(pools, src, dst)),
               "real_pairs_us": _per_call_us(lambda: cp.real_pairs(src, dst))}
        if hasattr(cp, "_launch_args"):
            args, batches = cp._launch_args(pools, src, dst)
            launch = build.library().copy_pages_launch
            stream = build.current_stream(args.device)
            row.update(
                pool_args_us=_per_call_us(lambda: cp._pool_args(pools)),
                launch_args_us=_per_call_us(
                    lambda: cp._launch_args(pools, src, dst)),
                bare_launch_us=_per_call_us(lambda: launch(
                    args.address, args.n_tensors, args.layers,
                    batches[0].buffer_info()[0], len(batches[0]) // 2,
                    stream)))
        torch.cuda.synchronize()
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    sys.exit(main())
