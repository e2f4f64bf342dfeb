"""The scheduler's decode lanes as CUDA graphs.

A tier's decode lane (``decode_block`` paged decode steps, ``hi_gate`` and
the pick after each, and for the chunked tiers the recurrent state's stage
and restore) is some thousands of small launches a tick whose host cost is
several times their device time.  :class:`LaneGraphs` captures the lane
once per key (tier, sampled or greedy, write block, pool dtype) and replays
it: the same kernels, in the same order, on the same data.

* **Inputs.**  A graph reads the tick's operand buffer, which the
  scheduler's upload rewrites at the same addresses every tick
  (``scheduler._Upload``), so a replay reads this tick's operands where the
  capture read the first's.  The slots' last tokens and theta, which the
  tick computes, are copied before each replay into two buffers of the
  graph's own, allocated before the capture.  The graph's outputs are its
  own tensors, read by the tick's one fetch.
* **Capture.**  The first tick of a key runs the lane eagerly on the
  capture stream, and those are the tick's outputs: the kernels' buffers
  cached per (device, stream) and cuBLAS's workspace are allocated there,
  outside the graph pool.  Then the lane is captured, which computes
  nothing.  The launch counters (``ops.launch_counts``) count the warm run
  and not the capture, and each replay adds what the warm run launched.
  All of a scheduler's graphs share one memory pool, freed with them.
* **Where it engages** (:func:`engages`): tiers on a CUDA device, off a
  mesh, in the plain role.  The speculative roles and the mesh path keep
  the eager lane.  A tick whose ``ops`` entry points were replaced since
  import (``ops.replaced``: tests and the benchmark's tally wrap them) runs
  eagerly too: a replay would skip the replacement.

Counters, per tier, in ``SchedCounters``: ``graph_captures``,
``graph_replays`` and ``graph_eager_ticks``.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.serving.telemetry import SchedCounters

# fn(last, theta) -> the lane's output tensors
LaneFn = Callable[..., Tuple[torch.Tensor, ...]]


def engages(device: torch.device, mesh, role: str) -> bool:
    """Whether a tier's decode lane runs as a CUDA graph: on a CUDA device,
    off a mesh (whose collectives stay eager), in the plain role."""
    return device.type == "cuda" and mesh is None and role == "plain"


class _Captured:
    """One captured lane: its graph, static inputs and outputs, and the
    kernel launches one run of it makes."""
    __slots__ = ("graph", "last", "theta", "outs", "launches")


class LaneGraphs:
    """The decode-lane graphs of one scheduler (module docstring)."""

    def __init__(self, device: torch.device, counters: SchedCounters):
        self.device = device
        self.counters = counters
        cuda = device.type == "cuda"
        self.pool = torch.cuda.graph_pool_handle() if cuda else None
        self.stream = torch.cuda.Stream(device) if cuda else None
        self._graphs: Dict[tuple, _Captured] = {}

    def run(self, key: tuple, tier: str, fn: LaneFn, last: torch.Tensor,
            theta: torch.Tensor
            ) -> Optional[Tuple[Tuple[torch.Tensor, ...], bool]]:
        """This tick's lane of ``tier``: (outputs, replayed), or None where
        the caller runs it eagerly (an entry point of ``ops`` replaced)."""
        c = self.counters
        if ops.replaced():
            c.graph_eager_ticks[tier] = c.graph_eager_ticks.get(tier, 0) + 1
            return None
        ent = self._graphs.get(key)
        if ent is None:
            outs = self._capture(key, fn, last, theta)
            c.graph_captures[tier] = c.graph_captures.get(tier, 0) + 1
            return outs, False
        ent.last.copy_(last)
        ent.theta.copy_(theta)
        ent.graph.replay()
        ops.add_launch_counts(ent.launches)
        c.graph_replays[tier] = c.graph_replays.get(tier, 0) + 1
        return ent.outs, True

    def _capture(self, key, fn, last, theta):
        main = None
        if self.stream is not None:
            main = torch.cuda.current_stream(self.device)
            self.stream.wait_stream(main)
        before = ops.launch_counts()
        ent = _Captured()
        with (contextlib.nullcontext() if self.stream is None
              else torch.cuda.stream(self.stream)):
            # the tick's own lane, eagerly: per-stream kernel buffers and
            # cuBLAS's workspace come from the ordinary allocator
            outs = fn(last, theta)
            warm = ops.launch_counts()
            # static inputs, outside the graph pool; writable by the next
            # ticks whether or not they run under inference mode
            with torch.inference_mode(False):
                ent.last, ent.theta = last.clone(), theta.clone()
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin(pool=self.pool,
                                capture_error_mode="thread_local")
            try:
                ent.outs = fn(ent.last, ent.theta)
            finally:
                graph.capture_end()
        # the capture launched nothing: take back what it counted
        ops.add_launch_counts({k: warm[k] - v
                               for k, v in ops.launch_counts().items()})
        if main is not None:
            main.wait_stream(self.stream)
            for t in outs:
                t.record_stream(main)
        ent.graph = graph
        ent.launches = {k: warm[k] - before[k] for k in warm}
        self._graphs[key] = ent
        return outs
