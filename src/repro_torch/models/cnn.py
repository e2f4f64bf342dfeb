"""CNN classifiers for the paper's three use cases (§3–§5).

* ``SML_CIFAR``  — the paper's 5-layer tinyML CNN: conv → maxpool → flatten →
  dense → dense (§4, 0.45 MB TFLite, 62.58% on CIFAR-10).
* ``LML_CIFAR``  — the EfficientNet stand-in L-ML (deeper conv stack; the
  paper uses EfficientNet at 95%).
* ``FAULT_CNN``  — the 8-layer CNN of [38] for CWRU fault diagnosis (§3),
  consuming 64x64 grey images built from 4096-sample vibration windows.
* ``SML_BINARY`` — the dog/not-dog relevance filter (§5, 0.23 MB, sigmoid).

The reference's layout: NHWC input, HWIO conv weights, ``(in, out)`` dense
weights, params ``{"convs": [...], "dense": [...], "head": {...}}``.
:func:`apply_cnn` permutes to NCHW inside for ``F.conv2d`` /
``F.max_pool2d`` and back before the flatten, so the dense weights see the
reference's (H, W, C) order.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


@dataclass(frozen=True)
class CNNConfig:
    name: str
    in_shape: Tuple[int, int, int]          # (H, W, C)
    conv_channels: Sequence[int]            # one conv per entry
    pool_every: int                          # maxpool 2x2 after every k convs
    dense_sizes: Sequence[int]               # hidden dense layers
    num_classes: int                          # 1 => binary sigmoid head
    global_pool: bool = False                 # global max-pool before dense
                                              # (translation-invariant head —
                                              # what EfficientNet-class models
                                              # have and the tinyML S-ML lacks)


SML_CIFAR = CNNConfig("sml-cifar", (32, 32, 3), (32,), 1, (64,), 10)
LML_CIFAR = CNNConfig("lml-cifar", (32, 32, 3), (32, 64, 64, 128, 128), 2,
                      (256,), 10, global_pool=True)
FAULT_CNN = CNNConfig("fault-cnn", (64, 64, 1), (16, 32, 32, 64, 64, 64), 2,
                      (128,), 10, global_pool=True)
SML_BINARY = CNNConfig("sml-binary", (32, 32, 3), (32,), 1, (32,), 1)


def init_cnn(gen: torch.Generator, cfg: CNNConfig, device="cuda",
             dtype=torch.float32) -> Params:
    """Random params at the reference's scales (normal / sqrt(fan_in),
    zero biases), drawn from ``gen`` on its device, then moved to
    ``device``.  (The numbers differ from the reference's: torch's
    generator is not jax's.  Parity tests bridge the reference's params.)"""

    def normal(shape, fan_in):
        w = torch.randn(shape, generator=gen, device=gen.device)
        return (w / math.sqrt(fan_in)).to(device=device, dtype=dtype)

    def zeros(n):
        return torch.zeros((n,), dtype=dtype, device=device)

    params: Params = {"convs": [], "dense": []}
    c_in = cfg.in_shape[2]
    h, w = cfg.in_shape[:2]
    for i, c_out in enumerate(cfg.conv_channels):
        params["convs"].append({"w": normal((3, 3, c_in, c_out), 9 * c_in),
                                "b": zeros(c_out)})
        c_in = c_out
        if (i + 1) % cfg.pool_every == 0:
            h, w = h // 2, w // 2
    d_in = c_in if cfg.global_pool else h * w * c_in
    for d_out in cfg.dense_sizes:
        params["dense"].append({"w": normal((d_in, d_out), d_in),
                                "b": zeros(d_out)})
        d_in = d_out
    params["head"] = {"w": normal((d_in, cfg.num_classes), d_in),
                      "b": zeros(cfg.num_classes)}
    return params


def apply_cnn(params: Params, cfg: CNNConfig, x: torch.Tensor) -> torch.Tensor:
    """x: (B, H, W, C) -> logits (B, num_classes) float32."""
    x = x.permute(0, 3, 1, 2)                              # NCHW
    for i, cp in enumerate(params["convs"]):
        # HWIO -> OIHW; a 3x3 SAME convolution at stride 1
        x = F.relu(F.conv2d(x, cp["w"].permute(3, 2, 0, 1), cp["b"],
                            padding=1))
        if (i + 1) % cfg.pool_every == 0:
            x = F.max_pool2d(x, 2, 2)                      # VALID: floors
    if cfg.global_pool:
        x = x.amax(dim=(2, 3))
    else:
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # (H, W, C) order
    for dp in params["dense"]:
        x = F.relu(x @ dp["w"] + dp["b"])
    return (x @ params["head"]["w"] + params["head"]["b"]).float()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def num_params(params: Params) -> int:
    return sum(p.numel() for p in _leaves(params))


def model_size_mb(params: Params, bytes_per_param: int = 1) -> float:
    """Size if quantised to int8 (the paper's TFLite models are quantised)."""
    return num_params(params) * bytes_per_param / 1e6
