"""Bridge the reference's parameter pytree into the port.

The reference's params are nested dicts of arrays; the caller hands them
over as numpy (``jax.tree.map(np.asarray, params)``), so this module never
imports jax.  The port keeps the reference's layout unchanged: layers
stacked on a leading ``(L, ...)`` axis, dense weights ``(in, out)`` applied
as ``x @ W``.  The bridge therefore only converts leaves.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def params_from_numpy(tree: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """Nested dict of numpy arrays -> the same nesting of torch tensors, of
    the same dtypes, on ``device``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = params_from_numpy(v, device)
        else:
            out[k] = torch.from_numpy(np.array(v, copy=True)).to(device)
    return out
