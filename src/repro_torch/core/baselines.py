"""The paper's §6 comparison baselines, with its measured timing model.

The paper's testbed constants (Raspberry Pi 4B ED, Tesla-T4 ES, 802.11 5 GHz
WLAN at 10.45 MB/s) are kept as a calibrated timing model so Figure 8 can be
reproduced quantitatively on any host:

  t_local   = 0.99 ms     S-ML inference on the ED
  t_offload = 74.34 ms    image transfer + L-ML inference on the ES

DNN-partitioning constants come from Appendix Tables 4–6 (EfficientNet split
between the Pi and the ES).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

T_LOCAL_MS = 0.99
T_OFFLOAD_MS = 74.34
WLAN_MBPS = 10.45          # MB/s measured via iPerf (SD 0.6)

# Appendix Table 4: per-layer EfficientNet time (ms) on Pi / ES-GPU
PI_LAYER_MS = (328.9, 1640.7, 1131.7, 970.0, 1561.0, 1981.0, 539.8)
ES_LAYER_MS = (1.01, 2.51, 1.50, 2.16, 2.31, 2.89, 0.91)
# Appendix Table 5: per-layer activation size (MB) and transfer time (ms)
LAYER_OUT_MB = (3.06, 1.64, 1.13, 0.97, 1.56, 1.98, 0.53)
IMAGE_MB = 0.003
LAYER_COMM_MS = tuple(1000.0 * mb / WLAN_MBPS for mb in LAYER_OUT_MB)
IMAGE_COMM_MS = 1000.0 * IMAGE_MB / WLAN_MBPS


@dataclass
class TimingModel:
    t_local_ms: float = T_LOCAL_MS
    t_offload_ms: float = T_OFFLOAD_MS

    def makespan_ms(self, n_local: int, n_offload: int) -> float:
        """ED and ES pipelines run concurrently; the ED also fronts every
        offloaded sample's S-ML pass under HI (handled by caller)."""
        return max(n_local * self.t_local_ms, n_offload * self.t_offload_ms)

    def hi_makespan_ms(self, n: int, n_offload: int) -> float:
        """HI: every sample runs S-ML on the ED, then offloads overlap."""
        return n * self.t_local_ms + n_offload * self.t_offload_ms

    def throughput(self, n: int, makespan_ms: float) -> float:
        return n / (makespan_ms / 1000.0)


@dataclass
class BaselineResult:
    name: str
    n: int
    n_offloaded: int
    n_correct: int
    makespan_ms: float

    @property
    def accuracy(self) -> float:
        return self.n_correct / self.n

    @property
    def throughput(self) -> float:
        return self.n / (self.makespan_ms / 1000.0)


def tinyml(s_correct: np.ndarray, tm: TimingModel) -> BaselineResult:
    """No offload: accept every S-ML inference."""
    n = len(s_correct)
    return BaselineResult("tinyml", n, 0, int(s_correct.sum()),
                          n * tm.t_local_ms)


def full_offload(l_correct: np.ndarray, tm: TimingModel) -> BaselineResult:
    n = len(l_correct)
    return BaselineResult("full-offload", n, n, int(l_correct.sum()),
                          n * tm.t_offload_ms)


def omd(s_correct: np.ndarray, l_correct: np.ndarray,
        tm: TimingModel, rng: Optional[np.random.Generator] = None
        ) -> BaselineResult:
    """Offloading for Minimizing Delay: split so both tiers finish together.

    k local and n-k offloaded with k*t_l = (n-k)*t_o  ->  k = n*t_o/(t_l+t_o).
    Samples are assigned randomly (the scheduler is accuracy-blind).
    """
    n = len(s_correct)
    k = int(round(n * tm.t_offload_ms / (tm.t_local_ms + tm.t_offload_ms)))
    rng = rng or np.random.default_rng(0)
    perm = rng.permutation(n)
    local, remote = perm[:k], perm[k:]
    correct = int(s_correct[local].sum() + l_correct[remote].sum())
    return BaselineResult("omd", n, n - k, correct,
                          tm.makespan_ms(k, n - k))


def oma(s_correct: np.ndarray, l_correct: np.ndarray, time_budget_ms: float,
        tm: TimingModel, worst_case: bool = False,
        rng: Optional[np.random.Generator] = None) -> BaselineResult:
    """Offloading for Maximizing Accuracy under a makespan constraint.

    Offload as many samples as the budget allows (they gain L-ML accuracy);
    the rest run locally.  The scheduler only knows *average* accuracies, so
    which samples go where is random — or adversarial in the worst case
    (it offloads exactly the samples S-ML had right; paper §6 'OMA worst
    case').
    """
    n = len(s_correct)
    n_off = min(n, int(time_budget_ms / tm.t_offload_ms))
    n_loc = n - n_off
    # local work must also fit the budget
    if n_loc * tm.t_local_ms > time_budget_ms:
        n_loc = int(time_budget_ms / tm.t_local_ms)
        n_off = n - n_loc
        n_off = min(n_off, int(time_budget_ms / tm.t_offload_ms))
    if worst_case:
        order = np.argsort(~s_correct)       # correct-on-S first -> offloaded
    else:
        rng = rng or np.random.default_rng(1)
        order = rng.permutation(n)
    remote, local = order[:n_off], order[n_off:]
    correct = int(s_correct[local].sum() + l_correct[remote].sum())
    name = "oma-worst" if worst_case else "oma"
    return BaselineResult(name, n, n_off, correct,
                          tm.makespan_ms(len(local), n_off))


def dnn_partitioning(l_correct: np.ndarray, split_layer: int = 0
                     ) -> BaselineResult:
    """Neurosurgeon-style partitioning.  Appendix: for 32x32 inputs every
    split is dominated by full offload, so the optimal split IS full offload;
    other splits are provided for the Table-6 comparison."""
    n = len(l_correct)
    if split_layer == 0:
        per_sample = T_OFFLOAD_MS
    else:
        pi = sum(PI_LAYER_MS[:split_layer])
        comm = LAYER_COMM_MS[split_layer - 1]
        es = sum(ES_LAYER_MS[split_layer:])
        per_sample = pi + comm + es
    return BaselineResult(f"dnn-partition-L{split_layer}", n, n,
                          int(l_correct.sum()), n * per_sample)


def partition_per_sample_ms(split_layer: int) -> float:
    """Single-inference latency for a split at ``split_layer`` (Table 6)."""
    if split_layer == 0:
        return T_OFFLOAD_MS
    pi = sum(PI_LAYER_MS[:split_layer])
    comm = LAYER_COMM_MS[split_layer - 1]
    es = sum(ES_LAYER_MS[split_layer:])
    return pi + comm + es
