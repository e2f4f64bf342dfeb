#!/usr/bin/env python3
"""Readings of the comparison that decides ``correct``, over many seeds in
one process, at a cell's own size: the program's, and the control's (the
reference put in the program's place in TF32, the next precision below
the configuration's float32 with TF32 off).  The limits in
``hibench/cells/<cell>.json`` are set from these readings (``PERF.md``).

    python3 hibench/control.py --workload <cell> --seeds 1,2,3 [--seconds 0]

Each seed runs a short window (``--seconds``; 0 = one wave) at the cell's
own load and prints one JSON line: the program's readings, the control's,
the offloaded share, the S tier's confidence quantiles and the window's
numbers, and per sampled request its shared prefix and both relative
confidence differences.  Needs the card, as ``run.py`` does.
"""
from __future__ import annotations

import time

T0 = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if Path(sys.path[0]).resolve() == Path(__file__).resolve().parent:
    sys.path[0] = str(Path(__file__).resolve().parents[1])
else:
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from hibench import run  # noqa: E402


def _requests(rows, extra) -> list:
    """(id, shared prefix, offloaded, the program's and the control's
    relative confidence difference) per sampled request."""
    by_id = {r["id"]: r for r in rows}
    ctl = dict(extra.get("control_details", []))
    return [(i, int(by_id[i]["prefix"]), bool(by_id[i]["offloaded"]), rel,
             ctl.get(i)) for i, rel in extra["details"]]


def one(cell, seed: int, seconds: float) -> None:
    import numpy as np
    import torch
    extra = {"control": True}
    t = time.monotonic()
    res = run.execute(cell, seed, seconds, False, "cuda", extra=extra)
    rows = extra["rows"]
    confs = np.asarray([r["confidence"] for r in rows])
    line = {"seed": seed, "correct": res["correct"],
            "seconds": time.monotonic() - t,
            "readings": res["window"]["readings"],
            "control": extra["control"],
            "offload_share": float(np.mean([r["offloaded"] for r in rows])),
            "conf_q": {q: float(np.quantile(confs, q / 100))
                       for q in (5, 35, 50, 95)},
            "metrics": {k: v["value"] for k, v in res["metrics"].items()},
            "requests": _requests(rows, extra),
            "window": res["window"]}
    print(json.dumps(line), flush=True)
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    args = ap.parse_args()
    run._env()
    cell = run.load_cell(args.workload)
    for s in args.seeds.split(","):
        one(cell, int(s), args.seconds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
