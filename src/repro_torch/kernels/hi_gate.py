"""hi_gate — the fused HI decision module: confidence + argmax + threshold.

Replaces the reference's ``kernels/hi_gate.py`` ``hi_gate_pallas``.  For
(N, C) logits it returns ``conf`` (N,) f32, ``pred`` (N,) i32 (first-index
argmax) and ``offload = conf < theta`` (N,) i32.

* :func:`hi_gate_plain` — the plain PyTorch version, following the Pallas
  kernel's arithmetic.  The CPU path and the on-card comparison use it.
* :func:`hi_gate_cuda` — launches ``csrc/hi_gate.cu`` (the source's note
  says what bounds it and how it is built).  ``hi_gate_cuda.launches``
  counts its launches.
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


def hi_gate_cuda(logits: torch.Tensor, theta: torch.Tensor,
                 metric: str = "max_prob") -> Out:
    """Launch the kernel.  logits: (N, C) f32/bf16 contiguous on a CUDA
    device; theta: 0-d f32 tensor on the same device, read by the kernel
    through its pointer."""
    if logits.device.type != "cuda":
        raise ValueError(f"hi_gate_cuda needs a CUDA tensor, got "
                         f"{logits.device}")
    if logits.dtype not in _DTYPES:
        raise TypeError(f"hi_gate: logits dtype {logits.dtype} not in "
                        f"{sorted(map(str, _DTYPES))}")
    if logits.ndim != 2 or logits.shape[1] < 2 or not logits.is_contiguous():
        raise ValueError(f"hi_gate: logits must be contiguous (N, C>=2), got "
                         f"{tuple(logits.shape)}")
    if metric not in METRICS:
        raise ValueError(f"unknown confidence metric {metric!r}")
    if (not isinstance(theta, torch.Tensor) or theta.numel() != 1
            or theta.dtype != torch.float32 or theta.device != logits.device):
        raise ValueError("hi_gate: theta must be a one-element float32 tensor "
                         "on the logits' device")
    n, c = logits.shape
    conf = torch.empty((n,), dtype=torch.float32, device=logits.device)
    pred = torch.empty((n,), dtype=torch.int32, device=logits.device)
    off = torch.empty((n,), dtype=torch.int32, device=logits.device)
    lib = build.library()
    stream = torch.cuda.current_stream(logits.device).cuda_stream
    err = lib.hi_gate_launch(logits.data_ptr(), _DTYPES[logits.dtype], n, c,
                             METRICS[metric], theta.data_ptr(),
                             conf.data_ptr(), pred.data_ptr(), off.data_ptr(),
                             stream)
    build.check(err, "hi_gate")
    hi_gate_cuda.launches += 1
    return conf, pred, off


hi_gate_cuda.launches = 0
