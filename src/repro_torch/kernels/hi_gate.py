"""hi_gate — the fused HI decision module: confidence + argmax + threshold.

Replaces the reference's ``kernels/hi_gate.py`` ``hi_gate_pallas``.  For
(N, C) logits it returns ``conf`` (N,) f32, ``pred`` (N,) i32 (first-index
argmax) and ``offload = conf < theta`` (N,) i32.

* :func:`hi_gate_plain` — the plain PyTorch version, following the Pallas
  kernel's arithmetic.  The CPU path and the on-card comparison use it.
* :func:`hi_gate_cuda` — launches ``csrc/hi_gate.cu`` (the source's note
  says what bounds it and how it is built), each row split over
  :func:`gate_splits` blocks and merged in the same launch.
  ``hi_gate_cuda.launches`` counts its launches.
"""
from __future__ import annotations

import math
from typing import Tuple, Union

import torch

from repro_torch.kernels import build

METRICS = {"max_prob": 0, "margin": 1, "entropy": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

Out = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def hi_gate_plain(logits: torch.Tensor,
                  theta: Union[float, torch.Tensor],
                  metric: str = "max_prob") -> Out:
    if metric not in METRICS:
        raise ValueError(f"unknown confidence metric {metric!r}")
    x = logits.float()
    m = x.amax(dim=-1, keepdim=True)
    ex = torch.exp(x - m)
    z = ex.sum(dim=-1, keepdim=True)
    pred = x.argmax(dim=-1)                 # first index of the max
    if metric == "max_prob":
        conf = (ex.amax(dim=-1, keepdim=True) / z)[:, 0]
    elif metric == "margin":
        p = ex / z
        # second max: mask out the argmax column (a duplicated max gives 0)
        p2 = p.scatter(-1, pred[:, None], -1.0)
        conf = p.amax(dim=-1) - p2.amax(dim=-1)
    else:
        p = ex / z
        logp = (x - m) - torch.log(z)
        h = -(p * logp).sum(dim=-1)
        conf = 1.0 - h / math.log(float(x.shape[-1]))
    offload = (conf < theta).to(torch.int32)
    return conf, pred.to(torch.int32), offload


# the kernel's row splits: at least MIN_SPLIT_COLS columns each, about
# TARGET_BLOCKS blocks in all (two per SM on the H100's 132), at most
# MAX_SPLITS (csrc/hi_gate.cu kMaxSplits: the last block of a row merges
# the splits one a lane of a warp)
TARGET_BLOCKS = 264
MIN_SPLIT_COLS = 2048
MAX_SPLITS = 32
# one split's partial state in the workspace (csrc/hi_gate.cu kPartialWords)
PARTIAL_WORDS = 8


def gate_splits(n: int, c: int) -> int:
    """Blocks per row of the kernel, from the shapes alone (no device->host
    copy): about ``TARGET_BLOCKS`` in all, each split at least
    ``MIN_SPLIT_COLS`` columns and at most ``MAX_SPLITS`` of them, one
    split for small C.  At the S tier's (8, 151,936): 32 splits of ~4,750
    columns, 256 blocks."""
    return max(1, min(-(-TARGET_BLOCKS // n), c // MIN_SPLIT_COLS,
                      MAX_SPLITS))


# the merge workspace and row counters, per (device, stream): the last block
# of each row resets its counter, so they stay 0 between calls.  A split
# row means fewer than TARGET_BLOCKS rows and fewer than 2 * TARGET_BLOCKS
# partials (gate_splits), so the first allocation serves every call and a
# call captured in a CUDA graph allocates none.
_SCRATCH: dict = {}


def _scratch(dev: torch.device, stream: int, n: int, splits: int
             ) -> Tuple[int, int]:
    """The workspace's and the counters' addresses, checked to hold n rows
    of ``splits`` partials: the kernel writes them unchecked."""
    key = (dev.index, stream)
    t = _SCRATCH.get(key)
    if t is None:
        counters = torch.zeros((TARGET_BLOCKS,), dtype=torch.int32, device=dev)
        ws = torch.empty((2 * TARGET_BLOCKS * PARTIAL_WORDS,),
                         dtype=torch.float32, device=dev)
        t = _SCRATCH[key] = (counters, ws, ws.data_ptr(), counters.data_ptr())
    if n > t[0].numel() or n * splits * PARTIAL_WORDS > t[1].numel():
        raise ValueError(f"hi_gate: {n} rows of {splits} splits overrun the "
                         f"merge workspace")
    return t[2], t[3]


def hi_gate_cuda(logits: torch.Tensor, theta: torch.Tensor,
                 metric: str = "max_prob") -> Out:
    """Launch the kernel.  logits: (N, C) f32/bf16 contiguous on a CUDA
    device; theta: 0-d f32 tensor on the same device, read by the kernel
    through its pointer.  The three outputs are rows of one (3, N) int32
    tensor, conf viewed as float32."""
    if logits.device.type != "cuda":
        raise ValueError(f"hi_gate_cuda needs a CUDA tensor, got "
                         f"{logits.device}")
    code = _DTYPES.get(logits.dtype)
    if code is None:
        raise TypeError(f"hi_gate: logits dtype {logits.dtype} not in "
                        f"{sorted(map(str, _DTYPES))}")
    if logits.ndim != 2 or logits.shape[1] < 2 or not logits.is_contiguous():
        raise ValueError(f"hi_gate: logits must be contiguous (N, C>=2), got "
                         f"{tuple(logits.shape)}")
    m = METRICS.get(metric)
    if m is None:
        raise ValueError(f"unknown confidence metric {metric!r}")
    if (not isinstance(theta, torch.Tensor) or theta.numel() != 1
            or theta.dtype != torch.float32
            or theta.get_device() != logits.get_device()):
        raise ValueError("hi_gate: theta must be a one-element float32 tensor "
                         "on the logits' device")
    n, c = logits.shape
    dev = logits.device
    out = torch.empty((3, n), dtype=torch.int32, device=dev)
    splits = gate_splits(n, c)
    stream = build.current_stream(dev.index)
    ws = counters = None
    if splits > 1:
        ws, counters = _scratch(dev, stream, n, splits)
    err = build.library().hi_gate_launch(
        logits.data_ptr(), code, n, c, splits, m, theta.data_ptr(),
        out.data_ptr(), ws, counters, stream)
    build.check(err, "hi_gate")
    hi_gate_cuda.launches += 1
    return out[0].view(torch.float32), out[1], out[2]


hi_gate_cuda.launches = 0
