"""Checkpointing: the reference's ``checkpoint/io.py`` format, so that a
checkpoint written by either package loads in the other.

  <dir>/manifest.msgpack   — tree structure, shapes, dtypes, step
  <dir>/arrays.npz         — flattened leaves by index, ``a{i}``

Leaves are numbered in jax's order (``repro_torch.tree``: a dict by sorted
key), whatever the order a dict was built in.  numpy has no bfloat16, so a
bf16 leaf is written as its 2-byte words (``|V2``, as ``np.savez`` writes
the reference's ``ml_dtypes`` bfloat16) and read back through the
manifest's dtype string.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import msgpack
import numpy as np
import torch

from repro_torch.tree import leaves, treedef_str, unflatten

_BF16 = "bfloat16"


def _to_numpy(x: Any) -> np.ndarray:
    t = torch.as_tensor(x).detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _dtype_name(x: Any) -> str:
    t = torch.as_tensor(x)
    return _BF16 if t.dtype == torch.bfloat16 else str(_to_numpy(t).dtype)


def _to_tensor(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == _BF16:
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def save(directory: str, tree: Any, step: int = 0,
         extra: Optional[Dict[str, Any]] = None) -> None:
    os.makedirs(directory, exist_ok=True)
    flat = leaves(tree)
    arrays = {f"a{i}": _to_numpy(x) for i, x in enumerate(flat)}
    manifest = {
        "treedef": treedef_str(tree),
        "num_leaves": len(flat),
        "step": step,
        "shapes": [list(a.shape) for a in arrays.values()],
        "dtypes": [_dtype_name(x) for x in flat],
        "extra": extra or {},
    }
    with open(os.path.join(directory, "manifest.msgpack"), "wb") as f:
        f.write(msgpack.packb(manifest))
    np.savez(os.path.join(directory, "arrays.npz"), **arrays)


def restore(directory: str, like: Any) -> Tuple[Any, int]:
    """Restore into the structure of ``like`` (shapes must match; each leaf
    takes ``like``'s dtype and device)."""
    with open(os.path.join(directory, "manifest.msgpack"), "rb") as f:
        manifest = msgpack.unpackb(f.read())
    data = np.load(os.path.join(directory, "arrays.npz"))
    flat_like = leaves(like)
    if manifest["num_leaves"] != len(flat_like):
        raise ValueError("checkpoint structure mismatch: "
                         f"{manifest['num_leaves']} leaves vs {len(flat_like)}")
    flat = []
    for i, ref in enumerate(flat_like):
        arr = data[f"a{i}"]
        ref = torch.as_tensor(ref)
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"leaf {i}: shape {arr.shape} != "
                             f"{tuple(ref.shape)}")
        flat.append(_to_tensor(arr, manifest["dtypes"][i]).to(
            dtype=ref.dtype, device=ref.device))
    return unflatten(like, flat), manifest["step"]


def exists(directory: str) -> bool:
    return os.path.exists(os.path.join(directory, "manifest.msgpack"))
