"""The ambient mesh of the model code, and the layout helpers around it.

Torch has no ambient mesh, so :func:`use_mesh` sets one for a block of
code and :func:`current_mesh` reads it; outside such a block every helper
here is the identity, and the model code runs as it does on one device.

The port's mesh path runs the model on each rank's local shards as plain
tensors (``sharding/specs.py``: ``local_config`` / ``shard_params``), with
the partitioning explicit, as the reference's ``shard_map`` is.  Under a
mesh with ``model > 1`` whose ``cut`` names a module,
:func:`reduce_model` all-reduces that module's row-parallel product over
``model`` and :func:`gather_vocab` all-gathers vocab-sharded logits, so
``hi_gate`` and the sampler see whole rows.

The reference's activation constraints, :func:`shard_activation` and the
three named after what they constrain, return plain tensors unchanged; on
a ``DTensor`` they redistribute it to the placements the reference's spec
names.
"""
from __future__ import annotations

import contextlib
import warnings
from typing import FrozenSet, Iterator, List, Optional, Tuple

import torch

_STACK: List[Tuple[object, FrozenSet[str]]] = []


@contextlib.contextmanager
def use_mesh(mesh, cut: FrozenSet[str] = frozenset()) -> Iterator[None]:
    """Make ``mesh`` the ambient mesh inside the block (``None``: no mesh,
    as outside any block); ``cut`` names the modules whose params are this
    rank's ``model`` shards (``specs.cut_kinds``)."""
    _STACK.append((mesh, frozenset(cut)))
    try:
        yield
    finally:
        _STACK.pop()


def current_mesh():
    return _STACK[-1][0] if _STACK else None


def model_group(kind: str):
    """The ``model`` process group where the ambient mesh cuts ``kind``
    over more than one rank, else None."""
    if not _STACK:
        return None
    mesh, cut = _STACK[-1]
    if kind not in cut or mesh.shape.get("model", 1) == 1:
        return None
    return mesh.group("model")


def reduce_model(y: torch.Tensor, kind: str) -> torch.Tensor:
    """Sum a row-parallel product's partial results over ``model`` (in
    place), where the ambient mesh cuts ``kind``."""
    group = model_group(kind)
    if group is not None:
        torch.distributed.all_reduce(y, group=group)
    return y


@contextlib.contextmanager
def _quiet() -> Iterator[None]:
    """Newer torch steers the two tensor collectives below to
    ``*_single`` names that older ones lack: the old names, unwarned."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        warnings.simplefilter("ignore", DeprecationWarning)
        yield


def all_gather_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's ``x`` concatenated along ``dim`` in rank order (flat
    buffers, which gloo and nccl both take)."""
    import torch.distributed as dist
    n = dist.get_world_size(group)
    out = x.new_empty((n * x.numel(),))
    with _quiet():
        dist.all_gather_into_tensor(out, x.contiguous().reshape(-1),
                                    group=group)
    return torch.cat(out.view(n, *x.shape).unbind(0), dim=dim)


def reduce_scatter_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Sum ``x`` over the group and keep this rank's block of ``dim``."""
    import torch.distributed as dist
    n = dist.get_world_size(group)
    parts = torch.stack(x.chunk(n, dim=dim))
    out = x.new_empty((parts[0].numel(),))
    with _quiet():
        dist.reduce_scatter_tensor(out, parts.reshape(-1), group=group)
    return out.view(parts.shape[1:])


def gather_vocab(logits: torch.Tensor) -> torch.Tensor:
    """Whole vocab rows from the ``model`` shards of the lm_head's
    product, where the ambient mesh cuts the lm_head."""
    group = model_group("lm_head")
    if group is None:
        return logits
    return all_gather_dim(logits, group, logits.ndim - 1)


# ---------------------------------------------------------------------------
# the reference's activation constraints
# ---------------------------------------------------------------------------

def _redistribute(x, spec):
    """A DTensor ``x`` redistributed to ``spec`` (one entry per tensor
    dim: an axis name, a tuple of them, or None) over its own mesh."""
    from torch.distributed.tensor import Replicate, Shard
    names = x.device_mesh.mesh_dim_names
    placements = [Replicate()] * len(names)
    for dim, ax in enumerate(spec):
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            if a in names:
                placements[names.index(a)] = Shard(dim)
    return x.redistribute(x.device_mesh, placements)


def _is_dtensor(x) -> bool:
    return type(x).__name__ == "DTensor"


def shard_activation(x, *, extra: Tuple[Optional[str], ...] = ()):
    """A batch-leading activation over the widest dividing set of batch
    axes: (pod, data, model) when the batch divides all three, else
    (pod, data), else (data,), else unconstrained."""
    mesh = current_mesh()
    if mesh is None or not _is_dtensor(x):
        return x
    for cand in (("pod", "data", "model"), ("pod", "data"), ("data",)):
        axes = tuple(a for a in cand if a in mesh.shape)
        if not axes:
            continue
        n = 1
        for a in axes:
            n *= mesh.shape[a]
        if x.shape[0] % n == 0:
            rest = list(extra) + [None] * (x.ndim - 1 - len(extra))
            # never reuse an axis already consumed by the batch dim
            rest = [None if r in axes else r for r in rest]
            return _redistribute(x, (axes, *rest))
    return x


def shard_hidden(h):
    """(B, S, D) residual stream: batch over (pod, data), D replicated."""
    return shard_activation(h)


def shard_experts(buf):
    """(E, C, D) MoE dispatch buffers: experts over ``model``."""
    mesh = current_mesh()
    if mesh is None or not _is_dtensor(buf) or \
            buf.shape[0] % mesh.shape["model"]:
        return buf
    return _redistribute(buf, ("model",) + (None,) * (buf.ndim - 1))


def shard_logits(logits):
    """(B, S, V) or (B, V): batch over (pod, data); V over ``model`` when
    it divides."""
    mesh = current_mesh()
    if mesh is None or not _is_dtensor(logits):
        return logits
    v_ax = "model" if logits.shape[-1] % mesh.shape["model"] == 0 else None
    return shard_activation(logits,
                            extra=(None,) * (logits.ndim - 2) + (v_ax,))
