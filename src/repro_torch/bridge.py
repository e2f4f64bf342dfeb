"""Bridge the reference's parameter pytree into the port.

The reference's params are nested dicts (and lists) of arrays; the caller
hands them over as numpy (``jax.tree.map(np.asarray, params)``), so this
module never imports jax.  The port keeps the reference's layout unchanged: layers
stacked on a leading ``(L, ...)`` axis, dense weights ``(in, out)`` applied
as ``x @ W``.  The bridge therefore only converts leaves.  The same holds
for the reference's caches (bf16 pools and conv windows, int8 pools and
their float32 scale rows), so the tests can hand a reference pool to the
port and compare pools.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


def params_from_numpy(tree: Any, device="cuda") -> Any:
    """Nested dicts and lists of numpy arrays -> the same nesting of torch
    tensors, of the same dtypes (bfloat16 included, which numpy holds as
    ``ml_dtypes.bfloat16``), on ``device``.  Lists map element by element
    (the CNNs' ``"convs"`` and ``"dense"`` hold lists of dicts)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [params_from_numpy(v, device) for v in tree]
    a = np.array(tree, copy=True)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)
