"""Accounting: turn cascade outputs + ground truth into the paper's tables."""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.baselines import BaselineResult, TimingModel
from repro_torch.core.cost import CostReport


def hi_report(pred: np.ndarray, s_pred: np.ndarray, served_remote: np.ndarray,
              offload_mask: np.ndarray, labels: np.ndarray, l_pred: Optional[np.ndarray],
              beta: float, name: str = "hierarchical-inference") -> CostReport:
    """Build a Table-1-style row from cascade outputs.

    wrong_local  = accepted-local (not offloaded) and wrong
    wrong_remote = served remotely and wrong
    """
    pred = np.asarray(pred)
    labels = np.asarray(labels)
    served = np.asarray(served_remote, bool)
    offl = np.asarray(offload_mask, bool)
    wrong = pred != labels
    return CostReport(
        approach=name,
        n=len(labels),
        offloaded=int(offl.sum()),
        wrong_local=int((wrong & ~served).sum()),
        wrong_remote=int((wrong & served).sum()),
        beta=beta,
    )


def baseline_report(r: BaselineResult, beta: float) -> CostReport:
    return CostReport(
        approach=r.name, n=r.n, offloaded=r.n_offloaded,
        wrong_local=int(r.n - r.n_correct), wrong_remote=0, beta=beta)


def hi_baseline_result(report: CostReport, tm: TimingModel) -> BaselineResult:
    """Timing view of an HI run (for the Fig. 8 comparison)."""
    return BaselineResult(
        name=report.approach, n=report.n, n_offloaded=report.offloaded,
        n_correct=report.n - report.misclassified,
        makespan_ms=tm.hi_makespan_ms(report.n, report.offloaded))


def format_table(rows) -> str:
    rows = [r.row() if hasattr(r, "row") else r for r in rows]
    keys = list(rows[0].keys())
    widths = {k: max(len(str(k)), *(len(f"{r[k]:.2f}" if isinstance(r[k], float)
                                        else str(r[k])) for r in rows))
              for k in keys}
    def fmt(v):
        return f"{v:.2f}" if isinstance(v, float) else str(v)
    lines = [" | ".join(k.ljust(widths[k]) for k in keys)]
    lines.append("-+-".join("-" * widths[k] for k in keys))
    for r in rows:
        lines.append(" | ".join(fmt(r[k]).ljust(widths[k]) for k in keys))
    return "\n".join(lines)
