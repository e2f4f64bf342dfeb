"""Random weights of both tiers, made on the device from the run's seed.

The benchmark makes the weights and hands the same tensors to the program
and to the reference.  The tree has the layout the program serves
(``{"embed", "layers": {...stacked over layers...}, "final_norm",
"lm_head"}``), float32 as served.  One ``torch.Generator`` on the device
draws each stacked leaf in one call, scaled in place: std 1/sqrt(fan_in)
for projections and the router, 0.02 for the embedding, norm scales 1.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from hibench.reference.dims import Dims


def _normal(gen: torch.Generator, shape, std: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device).mul_(std)


def _proj(gen: torch.Generator, shape) -> torch.Tensor:
    """A stacked (..., in, out) projection."""
    return _normal(gen, shape, 1.0 / math.sqrt(shape[-2]))


def _swiglu(gen: torch.Generator, lead, d: int, ff: int) -> Dict:
    lead = tuple(lead)
    return {"wi": _proj(gen, lead + (d, ff)), "wg": _proj(gen, lead + (d, ff)),
            "wo": _proj(gen, lead + (ff, d))}


def make(gen: torch.Generator, dm: Dims) -> Dict:
    n, d, hd = dm.layers, dm.d, dm.head_dim
    dev = gen.device
    layers = {"ln1": {"scale": torch.ones(n, d, device=dev)},
              "attn": {"wq": _proj(gen, (n, d, dm.heads * hd)),
                       "wk": _proj(gen, (n, d, dm.kv_heads * hd)),
                       "wv": _proj(gen, (n, d, dm.kv_heads * hd)),
                       "wo": _proj(gen, (n, dm.heads * hd, d))},
              "ln2": {"scale": torch.ones(n, d, device=dev)}}
    if dm.moe:
        layers["router"] = _proj(gen, (n, d, dm.experts))
        layers["experts"] = _swiglu(gen, (n, dm.experts), d, dm.ff_expert)
        if dm.shared:
            layers["shared"] = _swiglu(gen, (n,), d, dm.shared * dm.ff_expert)
    else:
        layers["mlp"] = _swiglu(gen, (n,), d, dm.ff)
    return {"embed": _normal(gen, (dm.vocab, d), 0.02),
            "layers": layers,
            "final_norm": {"scale": torch.ones(d, device=dev)},
            "lm_head": _proj(gen, (d, dm.vocab))}


def seed_for(seed: int, tag: int) -> int:
    """A 63-bit generator seed for one use of the run's seed."""
    return int(np.random.SeedSequence([seed, tag]).generate_state(
        2, np.uint32).view(np.uint64)[0] >> 1)


def make_tiers(seed: int, l_dims: Dims, s_dims: Dims, device) -> tuple:
    """(L weights, S weights), one generator for both, L first."""
    gen = torch.Generator(device=device).manual_seed(seed_for(seed, 1))
    return make(gen, l_dims), make(gen, s_dims)
