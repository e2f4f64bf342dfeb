"""Shape-only counts of one call of a case function on ``meta`` tensors:
the dry run's counterpart of the reference's ``launch/hlo_loop.py`` (FLOPs,
dot bytes and collective bytes from the lowered HLO, with ``while`` trip
counts reconstructed) and of ``compiled.memory_analysis()``.

The call runs eagerly, so every layer, microbatch and recomputed
activation executes and is counted as it runs: the counts are loop-aware
by construction.  Nothing is computed (meta tensors have no data), and a
``fake`` process group (``launch/mesh.dryrun_world``) answers the
collectives.  :func:`count` returns a :class:`Counts`:

* ``flops`` — the formulas of ``torch.utils.flop_counter`` (the
  registry ``FlopCounterMode`` reads: mm, bmm, addmm, baddbmm,
  convolutions, ...), and beside them the drain kernel's shape-only op
  (``kernels/ops.py``), 4 x B x H x S x D, applied op by op in the one
  dispatch mode that takes the other counts.  ``FlopCounterMode`` itself
  tries to decompose every op it meets and doubled a case's time; the
  tests hold the two totals equal;
* ``dot_bytes`` — operand plus result bytes of those same ops, the
  reference's ``FlopCount.dot_bytes``: an unfused estimate of the memory
  traffic of a matmul-dominated program;
* ``collectives`` — result bytes on this rank per collective kind, summed
  over the call, the reference's convention (``hlo_analysis.py:44-52``):
  the reduced tensor of an all-reduce, the gathered result of an
  all-gather, this rank's block of a reduce-scatter;
* ``peak_bytes`` — the high-water mark of live tensor bytes during the
  call, arguments included, tracked per storage with weakref callbacks.
  It is an estimate: it sees the tensors Python holds (autograd's saved
  tensors among them), in the order eager execution frees them, and knows
  nothing of an allocator's rounding, fragmentation or workspaces.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, Tuple

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry, register_flop_formula

from repro_torch.kernels import ops  # noqa: F401  (repro_torch::decode_attention)

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# c10d's ops (torch.distributed's in-place API) and the functional
# collectives, by name -> kind; the c10d ops' first argument is their result
_C10D = {"allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
         "allgather_": "all-gather", "_allgather_base_": "all-gather",
         "allgather_into_tensor_coalesced_": "all-gather",
         "reduce_scatter_": "reduce-scatter",
         "_reduce_scatter_base_": "reduce-scatter",
         "reduce_scatter_tensor_coalesced_": "reduce-scatter",
         "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
         "send": "collective-permute", "recv_": "collective-permute"}
_FUNCTIONAL = {"all_reduce": "all-reduce", "all_reduce_coalesced":
               "all-reduce", "all_gather_into_tensor": "all-gather",
               "all_gather_into_tensor_coalesced": "all-gather",
               "reduce_scatter_tensor": "reduce-scatter",
               "reduce_scatter_tensor_coalesced": "reduce-scatter",
               "all_to_all_single": "all-to-all"}


@register_flop_formula(torch.ops.repro_torch.decode_attention)
def _decode_attention_flops(q_shape, k_shape, *args, out_shape=None,
                            **kwargs) -> int:
    """Scores and the weighted sum over every cache row: the drain
    kernel's work at a full mask (a mask has no values on ``meta``)."""
    b, _, h, d = q_shape
    return 4 * b * h * k_shape[1] * d


def _tensors(tree) -> Iterator[torch.Tensor]:
    for leaf in pytree.tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            yield leaf


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


@dataclass
class Counts:
    """One call's counts on one rank; see the module docstring."""
    flops: float = 0.0
    dot_bytes: float = 0.0
    collectives: Dict[str, int] = field(
        default_factory=lambda: dict.fromkeys(COLLECTIVES, 0))
    peak_bytes: int = 0
    argument_bytes: int = 0
    output_bytes: int = 0


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class _Tracker(TorchDispatchMode):
    """Dot bytes, collective bytes and live storage bytes, op by op."""

    def __init__(self, counts: Counts):
        super().__init__()
        self.counts = counts
        self.live: Dict[int, list] = {}     # storage -> [bytes, holders]
        # id of a weakref to a holder -> (the weakref, its storage)
        self.refs: Dict[int, Tuple[weakref.ref, int]] = {}
        self.now = 0

    def hold(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        entry = self.live.get(key)
        if entry is None:
            entry = self.live[key] = [st.nbytes(), 0]
            self.now += entry[0]
            if self.now > self.counts.peak_bytes:
                self.counts.peak_bytes = self.now
        entry[1] += 1
        ref = weakref.ref(t, self._release)
        self.refs[id(ref)] = (ref, key)

    def _release(self, ref: weakref.ref) -> None:
        key = self.refs.pop(id(ref))[1]
        entry = self.live[key]
        entry[1] -= 1
        if entry[1] == 0:
            self.now -= entry[0]
            del self.live[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.counts.flops += formula(*args, **kwargs, out_val=out)
            self.counts.dot_bytes += _nbytes((args, kwargs)) + _nbytes(out)
        elif func.namespace == "c10d" and func._opname in _C10D:
            self.counts.collectives[_C10D[func._opname]] += _nbytes(args[0])
        elif (func.namespace == "_c10d_functional"
              and func._opname in _FUNCTIONAL):
            self.counts.collectives[_FUNCTIONAL[func._opname]] += \
                _nbytes(out)
        if isinstance(out, torch.Tensor):
            self.hold(out)
        elif isinstance(out, (tuple, list)):
            for t in out:
                if isinstance(t, torch.Tensor):
                    self.hold(t)
        return out


def count(fn: Callable, args: Tuple[Any, ...]) -> Tuple[Any, Counts]:
    """Run ``fn(*args)`` once under the counters; returns (its output,
    :class:`Counts`).  The arguments are live for the whole call."""
    counts = Counts(argument_bytes=_nbytes(args))
    tracker = _Tracker(counts)
    seen = set()
    for t in _tensors(args):
        key = _storage_key(t)
        if key not in seen:
            seen.add(key)
            tracker.hold(t)
    with tracker:
        out = fn(*args)
    arg_keys = {_storage_key(t) for t in _tensors(args)}
    counts.output_bytes = sum(
        t.untyped_storage().nbytes()
        for key, t in {_storage_key(t): t for t in _tensors(out)}.items()
        if key not in arg_keys)
    return out, counts
