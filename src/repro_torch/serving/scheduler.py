"""Continuous-batching scheduler over the paged KV pool, single device.

The port of the reference's ``serving/scheduler.py``: slot-level admission
instead of drained batches.  Each tier owns ``num_slots`` decode slots
backed by one :class:`KVPool`; every scheduler tick runs, per tier and in
this order:

1. **COW lane** (prefix sharing): the admission plans' copy-on-write page
   copies, so appends never touch a shared page;
2. **admit lane**: one batched (A, S_max) prefill of up to ``admit_width``
   admitted requests, with the prefix splice, and the prefix-cache logits
   save / restore;
3. **chunk lane** (``chunk_prefill``): one ``forward_chunk_paged`` pass over
   a (``chunk_width``, ``chunk_size``) lane that feeds up to W long prompts
   their next C tokens; a slot that consumes its last chunk samples token 0
   and joins decode in the same tick.  The pass runs only the lane's first
   ``chunk_lane_width`` rows, which hold its live ones, unless the family's
   rows interact (``model_zoo.independent_rows``).  With prefix sharing a
   chunked prompt starts at its cached prefix and stays on this lane
   however short the rest, and the full prompt pages each tick writes
   enter the page index for the next tick's admissions;
4. **decode lane**: ``decode_block`` decode steps for every decoding slot at
   per-slot positions; in speculative mode this is the S tier's DRAFT,
   with a copy of the recurrent rows after every step;
5. **verify lane** (``speculative``, L tier only): one
   ``forward_chunk_paged`` pass over the S tier's drafted block, the
   token-level S->L cascade.  Per slot, a block whose minimum hi_gate
   confidence clears theta is accepted at S-tier cost; otherwise the L
   logits re-derive each draft position greedily, the longest agreeing
   prefix is kept, the first divergence takes L's token (the bonus), and
   both tiers roll back the rejected tail: recurrent state through
   ``select_stage`` over the staged copies, attention state by rewinding
   the host position (``KVPool.truncate`` asserts the rewind never
   reaches a shared page).  The verify takes the S tier's drafts, staged
   states and last tokens as device tensors, and the S rollback takes L's
   ``keep`` on the device: nothing crosses to the host between the tiers.

Where the reference traces every lane into one executable and skips idle
ones with ``lax.cond``, the port runs each lane's tensor code eagerly and
branches in Python on host values that ``_TierRuntime.tick_inputs`` builds
from the host's own state (``any_cow``, ``any_prefill``, ``any_chunk``,
``any_live``): no device value is read inside a tick.  The tick's operands
cross to the card in one packed host->device copy, into one device buffer
allocated at the first tick, and its outputs come back in exactly one
device->host copy, through the engine's ``_host_fetch`` (tests monkeypatch
it to count).  The pools are updated in place; the order of the calls
keeps the reference's reads before its writes: COW before prefill, the
prefix splice before the suffix page writes, and full restores read the
pre-save prefix-cache logits.

Sentinels.  The reference marks unused rows with out-of-range indices and
lets XLA drop their writes (``mode="drop"``).  Here every such write has a
row to land in: the slot sentinel ``num_slots`` indexes a padding entry
past the real slots (of the last-token vector and of the recurrent
families' state rows), the prefix-row sentinel ``entries`` the prefix
cache's drop row, and unused pages the null page 0.

Recurrent state (SSM and hybrid families).  Every ``model_zoo`` hook
updates the pool in place, as the pages are: prefill and restores write the
admitted slots' rows, the chunk lane works on a gathered copy of its rows
and scatters back each row's state after exactly its ``chunk_keep`` inputs,
and the decode lane restores slots still mid chunk-prefill from a copy
taken before its steps.  A prompt whose first chunk starts at position 0
starts from a zero state, as a prefill does.

The L-tier queue enforces the time-constrained offloading drop rule (Fresa
& Champati, arXiv:2112.11413), and every S->L escalation crosses the
host-side transport model of ``serving/faults.py``: a seeded
``FaultSchedule`` (delay, loss, L outages, latency spikes) set with
:meth:`ContinuousScheduler.set_faults`, retries with capped backoff, and
the circuit breaker, whose open state runs the tick with theta
``FAIL_LOCAL_THETA`` (a device operand, so nothing is rebuilt).  Every
request ends with one record whose ``status`` is in ``faults.STATUSES``;
an outage releases busy L slots' pages through ``KVPool.free``, and
``validate=True`` checks both pools' invariants after every tick.
Speculative mode has no L queue, so an active schedule there raises, as in
the reference.

Observability.  :meth:`set_telemetry`, :meth:`set_audit`,
:meth:`set_watchdog` and :meth:`set_flight_recorder` install the host-side
collectors of ``telemetry.py``, ``audit.py`` and ``flight_recorder.py``.
Each hook is one ``is None`` branch when its collector is off; on, they
read host clocks and what the tick's one fetch brought back, and add no
device sync.  The phase marks are ``fault_tick``, ``build_operands``,
``dispatch`` (kernel launches, asynchronous on the card), ``host_fetch``
(where the device time surfaces) and ``postprocess``.
``kv_dtype="int8"`` stores both tiers' pages as int8 with one float32 scale
per physical page and kv head; the paged kernels dequantise in the gather
and the COW copies move the scale rows with their pages, in the same
launches as the pages.

``counters.compiles`` counts scheduler builds (the reference counts its one
AOT compile); the engine reports it as ``stream_compiles``.

CUDA graphs (``lane_graphs.py``).  On one CUDA device, off a mesh and
outside the speculative roles, each tier's decode lane is captured once per
key (tier, sampled, write block, pool dtype) and replayed.  The tick's
operands land at the same addresses every tick (``_Upload``), so a replay
reads this tick's values where the capture read the first's.  The counters
``graph_captures``, ``graph_replays`` and ``graph_eager_ticks`` count per
tier, and the live lane's telemetry span carries ``graph``.

The mesh path (``mesh=``, a ``launch/mesh.Mesh`` with axes ``("data",
"model")``) is the paper's topology at scale, SPMD over
``torch.distributed``: one process per device, every rank running this
host loop over the same requests, so that every host decision comes out
the same on every rank.

* **S tier: R = ``mesh.shape["data"]`` replicas** (the edge devices).
  Every rank keeps the host runtimes ``S0..S{R-1}``; admission walks them
  in turn.  Rank (d, m) holds replica d's pool on its device (the others'
  pools are host-side allocators over ``meta`` buffers, ``alloc=False``)
  and runs replica d's unchanged tier tick.  Its outputs are then
  all-gathered over ``data``, so every rank absorbs every replica's.
* **L tier: tensor parallel over ``model``** (the edge server), the same
  on every ``data`` row.  It runs the unchanged tier tick on
  ``sharding/specs.local_config`` with ``shard_params``' slices and a
  pool of the local kv heads (``paged_cache_specs``' cut), under the
  ``model`` sub-mesh (``sharding/act.use_mesh``): the row-parallel
  products all-reduce, the logits all-gather and the MoE FFN takes the
  expert-parallel dispatch.
* **Escalation staging.**  Escalated prompts cross through a
  ``(2, admit_width, S_max)`` int32 device buffer: the tick writes this
  tick's head-of-queue escalations into one half (the
  ``transfer_overlap`` phase), and the L admit lane gathers its rows from
  the other half, written last tick.  The host's L ``admit_tokens`` are
  zeroed, so the device copy is the one the lane reads.  The +1 tick is
  the modelled ED->ES hop: an escalation admits only once its staged row
  is readable (the ``ready`` gate).
* Still one device->host copy per tick on each rank, through
  ``engine._host_fetch``.  With ``validate=True`` the fetched tree also
  carries every rank's checksum of its outputs (all-gathered), and a
  divergence raises: ranks whose host decisions part would hang the next
  collective.

A (1, 1) mesh is semantics-free: tokens, statuses and offloads equal the
single-device path's bitwise, in bf16 and int8.  Speculative mode with a
mesh, and a mesh without both axes, raise with the reference's messages.
The reference's third refusal, ``use_kernel`` with ``model > 1``, guards
a GSPMD limit the port does not have: each rank launches the kernels on
its own local heads.
"""
from __future__ import annotations

import contextlib
import time
import warnings
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import HIConfig, ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import model_zoo
from repro_torch.serving import lane_graphs, sampler
from repro_torch.serving.batcher import AdmissionQueue, AdmittedRequest
from repro_torch.serving.faults import (FAIL_LOCAL_THETA, NO_FAULTS,
                                        CircuitBreaker, Escalation,
                                        EscalationLink, FaultSchedule,
                                        RetryPolicy)
from repro_torch.serving.kv_pool import AdmitPlan, KVPool
from repro_torch.serving.telemetry import SchedCounters, StatsView, Telemetry
from repro_torch.sharding import act
from repro_torch.sharding import specs as sharding_specs

# lanes whose ticks each tier counts from its host flags; "prefill" is the
# admit lane's batched prefill, skipped on ticks whose admissions all
# restore a whole prompt.  Telemetry's lane spans take these names, and
# ``verify`` for the speculative verify lane (the L tier's ``live`` flag)
# and the S tier's rollback after it
LANES = ("cow", "admit", "prefill", "chunk", "live")
# the lane context while telemetry is off: one shared object, no span
_NO_SPAN = contextlib.nullcontext()


def chunk_lane_width(live: int, width: int) -> int:
    """The rows the chunk lane runs for ``live`` scheduled rows of a
    ``width``-row lane: the smallest power of two below ``width`` that holds
    them, else ``width``.  A few fixed widths (1, 2, 4, W for W = 8), so
    each stays one shape per tier."""
    n = 1
    while n < live:
        n *= 2
    return n if n < width else width


def _write_block_key(chunk: int, sharing: bool) -> Optional[str]:
    """The decode lane's write block: the chunked tiers' ``draft_wblock``,
    else the sharing tiers' ``wblock``, else none (writes go through
    ``block``)."""
    return "draft_wblock" if chunk else "wblock" if sharing else None


class _Upload:
    """A scheduler's tick operands at fixed addresses.  The first tick
    records each array's (name, kind, shape, offset) in one run of int32
    words and allocates the words on the device (on the card also a pinned
    host copy of them); every tick packs its arrays into the host words,
    which cross in ONE host->device copy that does not block the host.
    ``views`` are the arrays on the device, the same tensors every tick:
    int32 views of the words, the float32 arrays (the sampling
    temperatures) as bit-cast views, and the bool arrays as bool tensors
    that each tick refreshes from their words.  A tick whose layout
    differs from the first raises: a scheduler's ticks have one set of
    shapes, and the decode-lane graphs (``lane_graphs.py``) read these
    addresses.

    The host words are rewritten in place, which is safe because the
    previous tick's one ``_host_fetch`` has synchronised the stream: its
    copy and every read of the device words finished before the host
    writes the next operands."""

    def __init__(self, device: torch.device):
        self.device = device
        self.metas: Optional[List[tuple]] = None

    def _allocate(self, n: int) -> None:
        cuda = self.device.type == "cuda"
        # outside inference mode: writable by every later tick
        with torch.inference_mode(False):
            self.host = torch.empty((n,), dtype=torch.int32, pin_memory=cuda)
            self.words = (torch.empty((n,), dtype=torch.int32,
                                      device=self.device)
                          if cuda else self.host)
            self.views: Dict[str, torch.Tensor] = {}
            self._bools = []
            for name, kind, shape, at in self.metas:
                t = self.words[at:at + int(np.prod(shape, dtype=np.int64))
                               ].view(shape)
                if kind == "b":
                    self.views[name] = torch.empty(shape, dtype=torch.bool,
                                                   device=self.device)
                    self._bools.append((self.views[name], t))
                else:
                    self.views[name] = (t.view(torch.float32) if kind == "f"
                                        else t)

    def __call__(self, arrays: Dict[str, np.ndarray]
                 ) -> Dict[str, torch.Tensor]:
        """This tick's ``arrays`` into ``views``."""
        metas, at = [], 0
        for name, a in arrays.items():
            kind = a.dtype.kind if a.dtype in (np.bool_, np.float32) else "i"
            metas.append((name, kind, a.shape, at))
            at += a.size
        if self.metas is None:
            self.metas = metas
            self._allocate(at)
        elif metas != self.metas:
            raise ValueError(
                "a tick's operands differ from the scheduler's first tick's: "
                f"{sorted(set(metas) ^ set(self.metas))}")
        words = self.host.numpy()
        for (_, kind, _, at), a in zip(metas, arrays.values()):
            words[at:at + a.size] = (a.view(np.int32) if kind == "f"
                                     else a).reshape(-1)
        if self.words is not self.host:
            self.words.copy_(self.host, non_blocking=True)
        for dst, src in self._bools:
            dst.copy_(src)
        return self.views


def _checksum(packed: torch.Tensor) -> torch.Tensor:
    """A position-weighted sum of a packed tree's int32 words, on the
    device (int64: the same wrap on every rank, were it to wrap)."""
    flat = packed.to(torch.int64)
    w = torch.arange(1, flat.numel() + 1, device=flat.device)
    return (flat * w).sum() % (2 ** 31 - 1)


def _tier_tick_fn(cfg: ModelConfig, metric: str, decode_block: int,
                  sharing: bool, chunk: int = 0, role: str = "plain",
                  graphs: Optional[lane_graphs.LaneGraphs] = None):
    """The per-tier tick: COW copies, batched admission prefill with the
    prefix-cache save / restore, the chunk-prefill lane and
    ``decode_block`` decode steps (``role`` ``"plain"``, or ``"spec_s"``,
    the speculative draft, which also returns its staged states), or, for
    ``role == "spec_l"``, the verify lane over the S tier's drafts.  ``tin``
    holds the tick's device operands, ``flags`` the host values its
    branches read.  With ``tel`` set, each lane that runs is a telemetry
    lane span of tier ``tier``.

    Each pass names its live positions (``live``: the admitted rows'
    prompt tokens from the page of their first uncached position, the
    chunk rows' kept tokens, the decoding slots, ``decode_live``); the MoE
    family routes only those, the others ignore them.

    With ``graphs`` set (``lane_graphs.engages``), the decode lane replays
    a CUDA graph per key (tier, sampled, write block, pool dtype), which
    reads the tick's operands where ``_Upload`` keeps them; the ticks that
    capture, and those whose ``ops`` entry points were replaced, run it
    eagerly."""
    wb_key = _write_block_key(chunk, sharing)

    def conf_of(logits, theta):
        return ops.hi_gate(logits, theta, metric)[0]

    def pick(logits, flags, seeds, idx, temps):
        """A lane's tokens: greedy, or, when a slot of this tier samples,
        ``sampler.sample`` under the rows' per-request keys
        ``request_keys(seeds, idx)`` (rows at temp 0 stay greedy)."""
        if not flags["sampled"]:
            return sampler.greedy(logits)
        return sampler.sample(sampler.request_keys(seeds, idx), logits, temps)

    def admit_and_prefix(params, tin, flags, pool: KVPool):
        """Batched admission prefill + prefix-cache save/restore (after the
        COW lane).  Returns the admission logits (A, V)."""
        core = pool.buffers
        a, s_max = tin["admit_tokens"].shape
        dev = tin["admit_tokens"].device
        if flags["any_prefill"]:
            # an admitted row's prompt from the page that holds its first
            # uncached position (that page is written whole)
            at = torch.arange(s_max, device=dev)
            live = ((at < tin["admit_len"][:, None])
                    & (tin["admit_slot"] < tin["last_tok"].shape[0])[:, None])
            if sharing:
                page = pool.page_size
                live &= at >= (tin["admit_start"] // page * page)[:, None]
            logits0, _ = model_zoo.prefill_paged(
                params, cfg, tin["admit_tokens"], tin["admit_len"],
                tin["admit_slot"], tin["admit_blocks"], core,
                start=tin["admit_start"] if sharing else None, live=live)
        else:
            logits0 = torch.zeros((a, cfg.vocab_size), dtype=torch.float32,
                                  device=dev)
        if sharing:
            prefix = pool.prefix_buffers
            # full restores read the PRE-SAVE prefix cache: a same-tick
            # eviction may recycle the restore's row for a computing
            # admission's save below (the gather copies before the write)
            restored = prefix["logits"][tin["restore_row"].long()]
            logits0 = torch.where(tin["restore_mask"][:, None], restored,
                                  logits0)
            model_zoo.snapshot_restore(cfg, core, prefix, tin["restore_row"],
                                       tin["restore_slot"])
            # sentinel rows (== entries) land in the drop row
            prefix["logits"][tin["save_row"].long()] = logits0
            model_zoo.snapshot_save(cfg, core, prefix, tin["save_row"],
                                    tin["admit_slot"])
        return logits0

    def chunk_lane(params, theta, tin, flags, pool: KVPool):
        """One multi-token pass over the chunk lane's first
        ``flags["chunk_width"]`` rows, which hold its live rows (views of
        the tick's upload).  Returns the sampled token and confidence at
        each row's last live position, zero-padded to the lane's W rows
        (consumed where ``chunk_fin``)."""
        w = tin["chunk_slot"].shape[0]
        dev = tin["chunk_slot"].device
        if not flags["any_chunk"]:
            return (torch.zeros((w,), dtype=torch.int64, device=dev),
                    torch.zeros((w,), dtype=torch.float32, device=dev))
        n = flags["chunk_width"]
        lane = {k: tin["chunk_" + k][:n] for k in (
            "tokens", "pos", "block", "wblock", "slot", "keep", "seed",
            "temp")}
        core = pool.buffers
        mini = model_zoo.gather_chunk_slots(cfg, core, lane["slot"],
                                            fresh=lane["pos"] == 0)
        # with the host's keep counts the recurrent families stage only
        # the boundary each row commits: select_stage(staged, keep)
        c = lane["tokens"].shape[1]
        live = torch.arange(c, device=dev) < lane["keep"][:, None]
        logits_c, mini, sel = model_zoo.forward_chunk_paged(
            params, cfg, lane["tokens"], lane["pos"], lane["block"], mini,
            write_block=lane["wblock"], keep=flags["chunk_keep"][:n],
            live=live)
        model_zoo.scatter_chunk_slots(cfg, core, mini, sel, lane["slot"])
        idx = torch.clamp(lane["keep"].long() - 1, min=0)
        last = logits_c[torch.arange(n, device=dev), idx]
        # token 0 of the request, as the admit lane's
        tok = pick(last, flags, lane["seed"], 0, lane["temp"])
        conf = conf_of(last, theta)
        if n < w:
            # the fetched tree, the mesh's gather and the fin scatter keep
            # the lane's (W,) shapes
            tok, conf = F.pad(tok, (0, w - n)), F.pad(conf, (0, w - n))
        return tok, conf

    def verify(params, theta, tin, flags, pool: KVPool, draft, wb):
        """The fused verify chunk over the S tier's drafts (greedy-only
        acceptance).  ``draft`` holds the S tick's device tensors: ``toks``
        and ``confs`` (K, B) and ``last0`` (B + 1,)."""
        k = decode_block
        block = tin["block"]
        b = block.shape[0]
        dev = block.device
        if not flags["any_live"]:
            zi = torch.zeros((b,), dtype=torch.int64, device=dev)
            return {"toks": torch.zeros((b, k), dtype=torch.int64,
                                        device=dev),
                    "confs": torch.zeros((b, k), dtype=torch.float32,
                                         device=dev),
                    "keep": zi, "accept": zi,
                    "esc": torch.zeros((b,), dtype=torch.bool, device=dev),
                    "n_emit": zi,
                    "match": torch.zeros((b, k), dtype=torch.bool,
                                         device=dev),
                    "draft_confs": torch.zeros((b, k), dtype=torch.float32,
                                               device=dev)}
        toks, confs = draft["toks"], draft["confs"]          # (K, B)
        # input j of the chunk is the token before draft j
        vin = torch.cat([draft["last0"][None, :b], toks[:-1]], 0).T
        core = pool.buffers
        pre = model_zoo.draft_stage(cfg, core, b)
        live = tin["draft_live"]
        vlog, core, staged = model_zoo.forward_chunk_paged(
            params, cfg, vin, tin["pos"], block, core, write_block=wb,
            live=live[:, None].expand(-1, k))
        lv = sampler.greedy(vlog)                             # (B, K)
        esc = (confs.min(dim=0).values < theta) & live
        match = lv == toks.T
        m = torch.where(match.all(dim=1), k,
                        torch.argmax((~match).to(torch.int32), dim=1))
        accept = torch.where(esc, m, k)                       # drafts kept
        keep = torch.where(esc, torch.clamp(m + 1, max=k), k)  # inputs kept
        model_zoo.restore_stage(cfg, core, pre, ~live)
        sel = model_zoo.select_stage(cfg, staged, keep)
        model_zoo.restore_stage(cfg, core, sel, live)
        cols = torch.arange(k, device=dev)[None, :]
        bonus = esc[:, None] & (cols == m[:, None])
        return {"toks": torch.where(bonus, lv, toks.T),
                # an L-verified token
                "confs": torch.where(bonus, 1.0, confs.T),
                "keep": keep, "accept": accept, "esc": esc,
                "n_emit": torch.where(esc & (m < k), m + 1, k),
                # the audit's ground truth: the raw per-position accept /
                # reject and the S draft confidences (``confs`` sets the
                # bonus position to 1.0, which would skew calibration)
                "match": match, "draft_confs": confs.T}

    def decode_lane(params, theta, lane, last, flags, core):
        """``decode_block`` decode steps of every slot from ``last``
        (B,) over the tick's operands ``lane``: the (K, B) tokens and
        confidences, and in the draft role the staged states after each
        step."""
        b = lane["block"].shape[0]
        pre_d = model_zoo.chunk_stage(cfg, core) if chunk else None
        toks, confs, snaps = [], [], []
        live = lane["decode_live"][:, None]
        for kk in range(decode_block):
            logits, core = model_zoo.decode_step_paged(
                params, cfg, last[:, None], lane["pos"] + kk, lane["block"],
                core, write_block=lane[wb_key] if wb_key else None,
                live=live)
            confs.append(conf_of(logits, theta))
            last = pick(logits, flags, lane["seeds"], lane["tok_idx"] + kk,
                        lane["temps"])
            toks.append(last)
            if role == "spec_s":
                snaps.append(model_zoo.draft_stage(cfg, core, b))
        if chunk:
            # slots still mid chunk-prefill took garbage decode steps:
            # their page writes went to the null page; restore their
            # recurrent state (none for the dense family) from the copy
            model_zoo.restore_stage(cfg, core, pre_d, ~lane["decode_live"])
        staged = {key: torch.stack([s[key] for s in snaps])
                  for key in (snaps[0] if snaps else {})}
        return torch.stack(toks), torch.stack(confs), staged

    def tick(params, theta, tin, flags, pool: KVPool, draft=None,
             tel: Optional[Telemetry] = None, tier: str = ""):
        a = tin["admit_tokens"].shape[0]
        n_slots = tin["last_tok"].shape[0]
        dev = tin["last_tok"].device
        # one padding entry past the slots takes the sentinel (== n_slots)
        # rows' writes
        last0 = torch.cat([tin["last_tok"].long(),
                           torch.zeros((1,), dtype=torch.int64, device=dev)])
        if flags["any_admit"]:
            if sharing and flags["any_cow"]:
                # copy-on-write first: prefill reads and decode appends
                # must see the private copies
                with _NO_SPAN if tel is None else tel.lane(tier, "cow"):
                    model_zoo.cow_pages(cfg, pool.buffers, flags["cow_src"],
                                        flags["cow_dst"])
            with _NO_SPAN if tel is None else tel.lane(tier, "admit"):
                logits0 = admit_and_prefix(params, tin, flags, pool)
                conf0 = conf_of(logits0, theta)
                tok0 = pick(logits0, flags, tin["admit_seed"], 0,
                            tin["admit_temp"])
                # admitted slots decode their own first tokens in the same
                # tick
                last0[tin["admit_slot"].long()] = tok0
        else:
            tok0 = torch.zeros((a,), dtype=torch.int64, device=dev)
            conf0 = torch.zeros((a,), dtype=torch.float32, device=dev)
        out = {"admit_tok": tok0, "admit_conf": conf0}
        if chunk:
            with _NO_SPAN if tel is None or not flags["any_chunk"] else \
                    tel.lane(tier, "chunk"):
                tok_c, conf_c = chunk_lane(params, theta, tin, flags, pool)
                if flags["any_chunk"]:
                    fin_slot = torch.where(tin["chunk_fin"],
                                           tin["chunk_slot"], n_slots)
                    last0[fin_slot.long()] = tok_c
            out["chunk_tok"] = tok_c
            out["chunk_conf"] = conf_c
        block = tin["block"]
        b = block.shape[0]
        if role == "spec_l":
            with _NO_SPAN if tel is None or not flags["any_live"] else \
                    tel.lane(tier, "verify"):
                out.update(verify(params, theta, tin, flags, pool, draft,
                                  tin[wb_key] if wb_key else None))
            return out
        staged = {}
        if flags["any_live"]:
            span = _NO_SPAN if tel is None else tel.lane(tier, "live")
            with span:
                last = last0[:n_slots]
                res = None
                if graphs is not None:
                    def replayable(lst, th):
                        return decode_lane(params, th, tin, lst, flags,
                                           pool.buffers)[:2]

                    res = graphs.run(
                        (tier, flags["sampled"], wb_key, pool.kv_dtype), tier,
                        replayable, last, theta)
                if res is None:
                    out["toks"], out["confs"], staged = decode_lane(
                        params, theta, tin, last, flags, pool.buffers)
                else:
                    (out["toks"], out["confs"]), replayed = res  # (K, B)
                    if tel is not None:
                        span.graph = replayed
        else:
            # no decoding slot this tick (e.g. all still chunk-prefilling)
            out["toks"] = torch.zeros((decode_block, b), dtype=torch.int64,
                                      device=dev)
            out["confs"] = torch.zeros((decode_block, b),
                                       dtype=torch.float32, device=dev)
        if role == "spec_s":
            return out, {"staged": staged, "toks": out["toks"],
                         "confs": out["confs"], "last0": last0}
        return out

    return tick


@dataclass
class _Active:
    """One request occupying a decode slot."""
    adm: AdmittedRequest
    steps: int
    tokens: List[int] = field(default_factory=list)
    confs: List[float] = field(default_factory=list)
    rounds: List = field(default_factory=list)   # spec: (escalated, n_emit)
    first_tok: float = 0.0                       # monotonic first-emit time
    hit_eos: bool = False

    def emit(self, tok: int, conf: float) -> None:
        if self.done:
            return
        if not self.tokens:
            self.first_tok = time.monotonic()
        self.tokens.append(int(tok))
        self.confs.append(float(conf))
        eos = self.adm.request.eos_id
        if eos is not None and int(tok) == eos:
            self.hit_eos = True

    @property
    def done(self) -> bool:
        return self.hit_eos or len(self.tokens) >= self.steps

    @property
    def ttft(self) -> float:
        return self.first_tok - self.adm.submit_time


class _TierRuntime:
    """Host-side slot state for one tier (numpy mirrors of tick operands)."""

    def __init__(self, cfg: ModelConfig, num_slots: int, max_context: int,
                 page_size: int, admit_width: int, device,
                 prefix_entries: int = 0, max_prompt_len: int = 0,
                 num_pages: Optional[int] = None, chunk_size: int = 0,
                 chunk_width: int = 2, spec: bool = False, name: str = "S",
                 dtype=torch.bfloat16, alloc: bool = True):
        if num_pages is None:
            # sharing headroom: beyond every slot's full context, enough
            # pages to RETAIN prefix_entries full prompts without evicting
            # under load
            num_pages = num_slots * (max_context // page_size) + 1
            num_pages += prefix_entries * (-(-max_prompt_len // page_size))
        self.pool = KVPool(cfg, num_slots, max_context, page_size,
                           num_pages=num_pages, dtype=dtype,
                           prefix_entries=prefix_entries, device=device,
                           alloc=alloc)
        self.sharing = prefix_entries > 0
        self.name = name               # tier label for telemetry tracks
        self.spec = spec
        self.num_slots = num_slots
        self.admit_width = admit_width
        self.chunk_size = chunk_size
        self.chunk_width = max(1, min(chunk_width, num_slots))
        self.chunk_sched: List = []    # (slot, keep, fin) rows THIS tick
        self.default_temp = 0.0      # engine-level fallback (Request wins)
        self.slot_req: List[Optional[_Active]] = [None] * num_slots
        self.last_tok = np.zeros((num_slots,), np.int32)
        self.pos = np.zeros((num_slots,), np.int32)
        # sampling: each slot's key seed (its request id), the index of
        # the token it samples next, and its temperature (0 = greedy)
        self.seeds = np.zeros((num_slots,), np.int32)
        self.tok_idx = np.zeros((num_slots,), np.int32)
        self.temps = np.zeros((num_slots,), np.float32)
        self.chunk_fed = np.zeros((num_slots,), np.int32)   # prompt tokens fed
        self.chunk_left = np.zeros((num_slots,), np.int32)  # 0 = decoding
        self.admitted: List[int] = []    # slots admitted THIS tick, row order
        self.plans: List[AdmitPlan] = []  # aligned admission plans
        # ticks in which each lane ran (host flags), for launch accounting
        self.lane_ticks: Dict[str, int] = dict.fromkeys(LANES, 0)
        # the chunk lane's fill over the ticks it ran: the real prompt
        # tokens it fed (its rows' keeps) and the width x C positions it
        # computed, and the ticks it ran at each width.  A family whose
        # rows interact (capacity-bounded routing) runs every tick at W
        self.chunk_tokens = 0
        self.chunk_positions = 0
        self.chunk_width_ticks: Dict[int, int] = {}
        self.independent_rows = model_zoo.independent_rows(cfg)
        # the chunk lane indexes the prompt pages it writes where partial
        # prefixes are shared (not in the paired speculative admission)
        self.registers = (self.sharing and self.pool.partial_prefix
                          and not spec)

    @property
    def busy(self) -> int:
        return sum(r is not None for r in self.slot_req)

    def free_slot(self) -> Optional[int]:
        for i, r in enumerate(self.slot_req):
            if r is None:
                return i
        return None

    def admit(self, adm: AdmittedRequest, steps: int, decode_block: int,
              tick: int) -> Optional[int]:
        """Claim a slot + pages for ``adm``; returns the slot index, or
        ``None`` if no capacity this tick (callers MUST test ``is None`` —
        slot 0 is falsy).  With sharing, the pool aliases the longest cached
        prefix and the returned plan carries start / restore / save / COW
        decisions.  With ``chunk_size`` set, a prompt longer than one chunk
        skips the admit lane unless it restores whole: its pages are claimed
        now and its tokens from ``plan.start`` on flow through the chunk
        lane C per tick.  (Under sharing the admit lane's pass is (A,
        ``max_prompt_len``) wide, so a short remainder there would cost far
        more than its chunk.)"""
        slot = self.free_slot()
        # decode writes reach bucket + steps - 2, plus <= K-1 overrun steps
        context = adm.bucket + max(steps - 1, 1) + (decode_block - 1)
        if slot is None:
            return None
        chunked = bool(self.chunk_size) and adm.bucket > self.chunk_size
        if self.sharing and not (chunked and self.spec):
            plan = self.pool.admit_prefix(slot, context, adm.bucket,
                                          adm.page_hashes, adm.full_hash,
                                          tick, register=not chunked)
            if plan is None:
                return None
            if plan.is_restore:
                chunked = False          # full hit: restoring beats chunking
        elif self.sharing:
            # speculative pairing: both tiers chunk in lock-step (the verify
            # lane needs both ready), so chunked admissions skip per-tier
            # prefix hits: a hit in one tier's index and not the other's
            # would desynchronise the pair's prefill
            try:
                self.pool.alloc(slot, context, tick=tick)
            except ValueError:
                return None
            plan = AdmitPlan(slot=slot)
        else:
            if not self.pool.can_alloc(context):
                return None
            self.pool.alloc(slot, context)
            plan = AdmitPlan(slot=slot)
        self.slot_req[slot] = _Active(adm, steps)
        self.pos[slot] = adm.bucket
        self.seeds[slot] = adm.request.request_id
        self.tok_idx[slot] = 1                 # token 0 comes from the prefill
        self.temps[slot] = (adm.request.temperature
                            if adm.request.temperature > 0
                            else self.default_temp)
        self.last_tok[slot] = 0                # replaced on-device by tok0
        if chunked:
            self.chunk_fed[slot] = plan.start
            self.chunk_left[slot] = adm.bucket - plan.start
        else:
            self.admitted.append(slot)
            self.plans.append(plan)
        return slot

    def release(self, slot: int) -> _Active:
        rec = self.slot_req[slot]
        self.slot_req[slot] = None
        self.pool.free(slot)
        self.pos[slot] = 0
        self.tok_idx[slot] = 0
        self.temps[slot] = 0.0
        self.last_tok[slot] = 0
        self.chunk_fed[slot] = 0
        self.chunk_left[slot] = 0
        return rec

    def tick_inputs(self, s_max: int) -> Tuple[Dict[str, np.ndarray],
                                               Dict[str, Any]]:
        """This tick's operands (numpy, copied to the device by the caller)
        and the host values the tick branches on: ``any_admit``,
        ``any_prefill``, ``any_cow`` with the ``cow_src``/``cow_dst`` pairs,
        ``any_chunk`` with the rows' ``chunk_keep`` and the lane's
        ``chunk_width``, ``any_live`` and ``sampled`` (a slot of this tier
        samples at temperature > 0).  ``decode_live`` marks the slots whose
        decode steps are real.  In speculative mode ``draft_live``
        marks the slots that draft and verify."""
        a = self.admit_width
        tokens = np.zeros((a, s_max), np.int32)
        lens = np.ones((a,), np.int32)
        slots = np.full((a,), self.num_slots, np.int32)    # drop sentinel
        blocks = np.zeros((a, self.pool.n_pages_per_slot), np.int32)
        seeds = np.zeros((a,), np.int32)
        temps = np.zeros((a,), np.float32)
        for row, slot in enumerate(self.admitted):
            adm = self.slot_req[slot].adm
            tokens[row, : adm.bucket] = adm.tokens
            lens[row] = adm.bucket
            slots[row] = slot
            blocks[row] = self.pool.block[slot]
            seeds[row] = self.seeds[slot]
            temps[row] = self.temps[slot]
        out = {
            "last_tok": self.last_tok.copy(),
            "pos": self.pos.copy(),
            "block": self.pool.block.copy(),
            "seeds": self.seeds.copy(),
            "tok_idx": self.tok_idx.copy(),
            "temps": self.temps.copy(),
            "admit_tokens": tokens,
            "admit_len": lens,
            "admit_slot": slots,
            "admit_blocks": blocks,
            "admit_seed": seeds,
            "admit_temp": temps,
        }
        flags: Dict[str, Any] = {"any_admit": bool(self.admitted),
                                 "sampled": bool((self.temps > 0).any())}
        if self.chunk_size:
            c, w = self.chunk_size, self.chunk_width
            npg = self.pool.n_pages_per_slot
            base = self.pool.write_block() if self.sharing else self.pool.block
            ctoks = np.zeros((w, c), np.int32)
            cslot = np.full((w,), self.num_slots, np.int32)  # drop sentinel
            cpos = np.zeros((w,), np.int32)
            ckeep = np.zeros((w,), np.int32)
            cfin = np.zeros((w,), bool)
            cblock = np.zeros((w, npg), np.int32)
            cwb = np.zeros((w, npg), np.int32)
            cseed = np.zeros((w,), np.int32)
            ctemp = np.zeros((w,), np.float32)
            dlive = np.zeros((self.num_slots,), bool)
            self.chunk_sched = []
            for slot in range(self.num_slots):
                rec = self.slot_req[slot]
                if rec is None:
                    continue
                left = int(self.chunk_left[slot])
                if left == 0:
                    dlive[slot] = True
                    continue
                row = len(self.chunk_sched)
                if row == w:
                    continue               # lane full: this slot waits a tick
                keep = min(c, left)
                fed = int(self.chunk_fed[slot])
                seg = rec.adm.tokens[fed:fed + c]
                ctoks[row, : len(seg)] = seg
                cslot[row] = slot
                cpos[row] = fed
                ckeep[row] = keep
                cfin[row] = keep == left
                cblock[row] = self.pool.block[slot]
                cwb[row] = base[slot]
                cseed[row] = self.seeds[slot]
                ctemp[row] = self.temps[slot]
                dlive[slot] = cfin[row]    # joins decode the same tick
                self.chunk_sched.append((slot, keep, bool(cfin[row])))
            out.update({
                "chunk_tokens": ctoks,
                "chunk_slot": cslot,
                "chunk_pos": cpos,
                "chunk_keep": ckeep,
                "chunk_fin": cfin,
                "chunk_block": cblock,
                "chunk_wblock": cwb,
                "chunk_seed": cseed,
                "chunk_temp": ctemp,
                "draft_live": dlive,
                "draft_wblock": np.where(dlive[:, None], base,
                                         0).astype(np.int32),
            })
            # live rows come first: the lane runs a prefix of its rows
            width = (chunk_lane_width(len(self.chunk_sched), w)
                     if self.independent_rows else w)
            flags["any_chunk"] = bool(ckeep.any())
            flags["chunk_keep"] = ckeep
            flags["chunk_width"] = width
            if flags["any_chunk"]:
                self.chunk_tokens += int(ckeep.sum())
                self.chunk_positions += width * c
                self.chunk_width_ticks[width] = \
                    self.chunk_width_ticks.get(width, 0) + 1
            flags["any_live"] = bool(dlive.any())
            out["decode_live"] = dlive
        else:
            flags["any_live"] = self.busy > 0
            out["decode_live"] = np.asarray(
                [r is not None for r in self.slot_req])
            if self.spec:
                out["draft_live"] = np.asarray(
                    [r is not None for r in self.slot_req])
        if not self.sharing:
            flags["any_prefill"] = bool(self.admitted)
            return out, self._count(flags)
        entries = self.pool.prefix_entries
        starts = np.zeros((a,), np.int32)
        restore_mask = np.zeros((a,), bool)
        restore_row = np.zeros((a,), np.int32)
        restore_slot = np.full((a,), self.num_slots, np.int32)
        save_row = np.full((a,), entries, np.int32)        # drop sentinel
        cow_src = np.zeros((a,), np.int32)
        cow_dst = np.zeros((a,), np.int32)
        any_prefill = False
        for row, (slot, plan) in enumerate(zip(self.admitted, self.plans)):
            starts[row] = plan.start
            if plan.is_restore:
                restore_mask[row] = True
                restore_row[row] = plan.restore_row
                restore_slot[row] = slot
            else:
                any_prefill = True
                if plan.save_row >= 0:
                    save_row[row] = plan.save_row
            if plan.cow is not None:
                cow_src[row], cow_dst[row] = plan.cow
        out.update({
            "admit_start": starts,
            "restore_mask": restore_mask,
            "restore_row": restore_row,
            "restore_slot": restore_slot,
            "save_row": save_row,
            "wblock": self.pool.write_block(),
        })
        flags.update(any_prefill=any_prefill, any_cow=bool(cow_dst.any()),
                     cow_src=cow_src, cow_dst=cow_dst)
        return out, self._count(flags)

    def _count(self, flags: Dict[str, Any]) -> Dict[str, Any]:
        for lane in LANES:
            if flags.get("any_" + lane):
                self.lane_ticks[lane] += 1
        return flags




class ContinuousScheduler:
    """Slot-level admission over paged pools for both cascade tiers.

    ``admit_width`` batches admission prefills like the drain path batches
    prompts; ``decode_block`` fuses that many decode steps per tick (and is
    the speculative draft length K).  ``prefix_sharing`` turns on the
    pools' content-addressed prefix reuse; ``chunk_prefill`` routes prompts
    longer than ``chunk_size`` through the chunk lane (C tokens per tick,
    interleaved with decode).  ``speculative`` fuses the S->L draft-verify
    token cascade into the tick (greedy-only; both tiers admit every
    request at the same slot index, so the L tier has ``num_slots``
    slots).  Kernels are chosen by the device the tiers' params live on:
    CUDA kernels on the card, their plain versions on the CPU.

    Sampling: a slot holds its request's temperature (``temperature``, the
    engine-wide default, for requests that set none) and samples token i
    under ``sampler.request_keys(request_id, i)``, built on the device from
    the tick's one upload, so a request's tokens do not depend on its slot,
    tick or batch row.  A tier whose slots are all at temperature 0 picks
    greedily and builds no keys.

    ``mesh`` runs the tiers on a ``("data", "model")`` mesh, one rank per
    device (module docstring): ``srts`` holds the R S-tier replicas,
    ``mesh_report`` the L tier's cut and replicated leaves.
    """

    def __init__(self, s_tier, l_tier, hi: HIConfig, *, max_prompt_len: int,
                 max_new_tokens: int, num_slots: int = 8,
                 l_slots: Optional[int] = None, page_size: int = 16,
                 admit_width: Optional[int] = None, decode_block: int = 4,
                 prefix_sharing: bool = False,
                 prefix_entries: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 chunk_prefill: bool = False, chunk_size: int = 8,
                 chunk_width: int = 2, speculative: bool = False,
                 kv_dtype: str = "bf16", mesh=None,
                 temperature: float = 0.0):
        if max_prompt_len % page_size:
            raise ValueError(f"max_prompt_len {max_prompt_len} must be a "
                             f"multiple of page_size {page_size}")
        if kv_dtype not in ("bf16", "int8"):
            raise ValueError(f"kv_dtype must be 'bf16' or 'int8', "
                             f"got {kv_dtype!r}")
        if mesh is not None:
            if speculative:
                raise NotImplementedError(
                    "speculative + mesh: the fused draft-verify cascade "
                    "pairs S and L slots 1:1, which a replicated S tier "
                    "breaks (the reference's refusal, same precedent as "
                    "speculative + faults)")
            for ax in ("data", "model"):
                if ax not in mesh.shape:
                    raise ValueError(
                        f"serving mesh needs axes ('data', 'model'), got "
                        f"{tuple(mesh.shape)}")
        if chunk_prefill and chunk_size < 1:
            raise ValueError(f"chunk_size {chunk_size} must be >= 1")
        self.kv_dtype = kv_dtype
        # int8: int8 pages + per-page, per-head float32 scales, dequantised
        # inside the paged kernels; bf16 keeps every bitwise invariant
        pool_dtype = torch.int8 if kv_dtype == "int8" else torch.bfloat16
        self.s = s_tier
        self.l = l_tier
        self.hi = hi
        self.device = s_tier.params["embed"].device
        self._mesh = mesh
        # the L tier as this rank runs it: whole, or its ``model`` shard
        l_cfg, self._l_params = l_tier.cfg, l_tier.params
        self._l_mesh, self._l_cut, self.mesh_report = None, frozenset(), None
        n_rep, self._rep = 1, 0
        if mesh is not None:
            n_rep, self._rep = int(mesh.shape["data"]), mesh.coord("data")
            self._l_mesh = mesh.sub("model")
            self._l_cut = sharding_specs.cut_kinds(l_tier.cfg, mesh)
            l_cfg = sharding_specs.local_config(l_tier.cfg, mesh)
            self._l_params = sharding_specs.shard_params(l_tier.params,
                                                         l_tier.cfg, mesh)
            self.mesh_report = sharding_specs.mesh_report(l_tier.params,
                                                          l_tier.cfg, mesh)
        self.max_prompt_len = max_prompt_len
        self.max_new_tokens = max_new_tokens
        self.decode_block = max(1, decode_block)
        self.prefix_sharing = prefix_sharing
        self.speculative = speculative
        self.chunk = int(chunk_size) if chunk_prefill else 0
        if speculative:
            l_slots = num_slots          # strict 1:1 slot pairing
        else:
            l_slots = l_slots if l_slots is not None else max(2, num_slots // 2)
        admit_width = admit_width if admit_width is not None else num_slots
        page = page_size
        raw_ctx = max_prompt_len + max_new_tokens + self.decode_block - 1
        max_context = -(-raw_ctx // page) * page
        s_entries = (prefix_entries if prefix_entries is not None
                     else 2 * num_slots) if prefix_sharing else 0
        l_entries = (prefix_entries if prefix_entries is not None
                     else 2 * l_slots) if prefix_sharing else 0
        self.srts: List[_TierRuntime] = [
            _TierRuntime(s_tier.cfg, num_slots, max_context, page,
                         admit_width, self.device, prefix_entries=s_entries,
                         max_prompt_len=max_prompt_len, num_pages=num_pages,
                         chunk_size=self.chunk, chunk_width=chunk_width,
                         spec=speculative,
                         name="S" if mesh is None else f"S{r}",
                         dtype=pool_dtype, alloc=r == self._rep)
            for r in range(n_rep)]
        self.lrt = _TierRuntime(l_cfg, l_slots, max_context, page,
                                admit_width if speculative
                                else min(admit_width, l_slots), self.device,
                                prefix_entries=l_entries,
                                max_prompt_len=max_prompt_len,
                                num_pages=num_pages, chunk_size=self.chunk,
                                chunk_width=chunk_width, spec=speculative,
                                name="L", dtype=pool_dtype)
        if mesh is not None:
            self.lrt.independent_rows = model_zoo.independent_rows(
                l_cfg, int(mesh.shape["model"]))
        # with chunking on and sharing off, every admit-lane prompt is <=
        # chunk_size: the batched admission pass shrinks from
        # (A, max_prompt_len) to (A, ~chunk_size)
        self._admit_s_max = max_prompt_len
        if self.chunk and not prefix_sharing:
            self._admit_s_max = min(max_prompt_len,
                                    -(-self.chunk // page) * page)
        self.counters = SchedCounters()
        self.stats: StatsView = StatsView(self.counters)
        self._upload = _Upload(self.device)
        # observability collectors (None = off: each hook is one branch)
        self.tel: Optional[Telemetry] = None
        self.aud = None                      # GateAudit
        self.wd = None                       # SLOWatchdog
        self.fr = None                       # FlightRecorder
        self._opens_seen = 0                 # breaker-open dump edge
        self._run_theta = float(hi.theta)    # the run's calibrated theta
        self._eff_theta = float(hi.theta)    # the theta in effect this tick
        # fault-injection state (host-side; per run)
        self.faults: FaultSchedule = NO_FAULTS
        self.policy: RetryPolicy = RetryPolicy()
        self.validate = False
        self._link: Optional[EscalationLink] = None
        self._breaker: Optional[CircuitBreaker] = None
        self._esc_meta: Dict[int, Escalation] = {}
        self._probe: Optional[int] = None
        self._tick0 = 0
        # escalation staging (mesh): rid -> row readable this tick (written
        # last tick), the rows being written this tick, and the buffer
        self._staged: Dict[int, int] = {}
        self._staged_next: Dict[int, int] = {}
        self._stage_wix = 0
        if mesh is not None:
            shape = (self.lrt.admit_width, self._admit_s_max)
            self._stage_tokens = np.zeros(shape, np.int32)
            self._stage = torch.zeros((2,) + shape, dtype=torch.int32,
                                      device=self.device)
        roles = ("spec_s", "spec_l") if speculative else ("plain", "plain")
        # the decode lanes' CUDA graphs (one pool for both tiers), where the
        # tiers' device, mesh and role allow them
        self._graphs = (lane_graphs.LaneGraphs(self.device, self.counters)
                        if lane_graphs.engages(self.device, mesh, roles[0])
                        else None)
        self._ticks = {
            key: _tier_tick_fn(cfg, hi.metric, self.decode_block,
                               rt.sharing, chunk=self.chunk, role=role,
                               graphs=self._graphs)
            for key, cfg, rt, role in (("s", s_tier.cfg, self.srt, roles[0]),
                                       ("l", l_cfg, self.lrt, roles[1]))}
        self.set_default_temperature(temperature)
        self.counters.compiles += 1

    @property
    def srt(self) -> _TierRuntime:
        """Replica 0's runtime: THE S runtime off a mesh."""
        return self.srts[0]

    @property
    def local_srt(self) -> _TierRuntime:
        """The S replica this rank runs on its device."""
        return self.srts[self._rep]

    @property
    def ranks(self) -> int:
        """Processes running this host loop together (1 off a mesh)."""
        return 1 if self._mesh is None else self._mesh.world

    def set_faults(self, faults: Optional[FaultSchedule] = None,
                   policy: Optional[RetryPolicy] = None,
                   validate: Optional[bool] = None) -> None:
        """Install the fault schedule / retry policy / per-tick invariant
        checking for subsequent ``run`` calls.  Host-side only: fault
        windows are run-relative ticks (each ``run`` re-anchors tick 0, so
        a schedule replays identically on a reused scheduler)."""
        if faults is not None:
            if self.speculative and faults.active:
                raise ValueError(
                    "fault injection models the S->L escalation QUEUE; "
                    "speculative mode has no L queue (escalation is fused "
                    "into the tick): the reference's refusal")
            self.faults = faults
        if policy is not None:
            self.policy = policy
        if validate is not None:
            self.validate = bool(validate)

    def set_telemetry(self, tel: Optional[Telemetry]) -> None:
        """Install (``Telemetry``) or remove (``None``) the telemetry
        collector for subsequent ``run`` calls."""
        self.tel = tel
        if tel is not None:
            tel.counters = self.counters
            tel.audit = self.aud

    def set_audit(self, aud) -> None:
        """Install (``GateAudit``) or remove (``None``) the gate audit.  The
        confidences it reads already come back in the tick's one
        ``_host_fetch``."""
        self.aud = aud
        if self.tel is not None:
            self.tel.audit = aud

    def set_watchdog(self, wd) -> None:
        """Install (``SLOWatchdog``) or remove (``None``) the once-per-tick
        SLO evaluation; breaches become telemetry instant events and
        flight-recorder dumps when those collectors are installed."""
        self.wd = wd

    def set_default_temperature(self, temperature: float) -> None:
        """The engine-level sampling temperature, used for requests that do
        not set their own (``Request.temperature > 0`` wins): keeps
        ``serve_stream`` consistent with ``serve``'s engine-wide
        temperature."""
        for rt in (*self.srts, self.lrt):
            rt.default_temp = float(temperature)

    def set_flight_recorder(self, fr) -> None:
        """Install (``FlightRecorder``) or remove (``None``) the bounded
        tick-snapshot ring.  Dumps fire on a watchdog breach, the breaker
        opening, a ``check_invariants`` failure and the idle-tick stall
        bound."""
        self.fr = fr

    @property
    def prefix_stats(self) -> Dict[str, int]:
        """Cumulative prefix-cache counters summed over both tiers: hits /
        full_hits / tokens_saved / cow_copies / evictions."""
        agg: Dict[str, int] = {}
        for rt in (*self.srts, self.lrt):
            for k, v in rt.pool.stats.items():
                agg[k] = agg.get(k, 0) + v
        return agg

    # -- host loop ----------------------------------------------------------

    def _dispatch(self, theta_t: torch.Tensor) -> Dict[str, Any]:
        """Build both tiers' operands, copy them to the device at once, run
        the tier ticks (in speculative mode the L verify takes the S
        draft's device tensors, and the S tier rolls back to L's ``keep``
        on the device), and host-fetch the outputs: the tick's single
        device->host copy.

        On a mesh, this rank's S replica's operands upload (every
        replica's host flags are built: they count its lane ticks and set
        its chunk schedule), the L admit lane takes its tokens from the
        staging buffer (its host copy is zeroed), the L tick runs on this
        rank's ``model`` shard, the S outputs are all-gathered over
        ``data``, and under ``validate`` every rank's output checksum
        rides the same fetch.  Returns {"s": each replica's S outputs, in
        replica order, "l": the L outputs}; speculative mode (no mesh)
        returns the S tier's outputs as such."""
        from repro_torch.serving import engine as engine_mod  # _host_fetch

        tel, mesh = self.tel, self._mesh
        host_in, s_flags = {}, []
        for r, rt in enumerate(self.srts):
            arrays, flags = rt.tick_inputs(self._admit_s_max)
            s_flags.append(flags)
            if r == self._rep:
                host_in.update({f"s.{k}": v for k, v in arrays.items()})
        arrays, l_flags = self.lrt.tick_inputs(self._admit_s_max)
        if mesh is not None:
            arrays["admit_tokens"] = np.zeros_like(arrays["admit_tokens"])
            host_in.update(self._stage_rows())
        host_in.update({f"l.{k}": v for k, v in arrays.items()})
        dev_in = self._upload(host_in)
        tins = {key: {k[2:]: v for k, v in dev_in.items()
                      if k.startswith(key + ".")} for key in ("s", "l", "t")}
        flags = {"s": s_flags[self._rep], "l": l_flags}
        if tel is not None:
            tel.mark("build_operands")
        if mesh is not None:
            # tick top: this tick's escalations into the write half; the
            # admit lane reads the other half, written last tick
            wix = self._stage_wix
            self._stage[wix] = tins["t"]["tokens"]
            tins["l"]["admit_tokens"] = self._stage[1 - wix][
                tins["t"]["row"].long()]
            if tel is not None:
                tel.mark("transfer_overlap")
        if tel is not None:
            tel.begin_dispatch()
        outs = {"s": {}, "l": {}}
        s_name, l_name = self.local_srt.name, self.lrt.name
        if self.speculative:
            s_out, ext = self._ticks["s"](self.s.params, theta_t, tins["s"],
                                          flags["s"], self.srt.pool,
                                          tel=tel, tier=s_name)
            outs["s"] = s_out
            outs["l"] = self._ticks["l"](self.l.params, theta_t, tins["l"],
                                         flags["l"], self.lrt.pool,
                                         draft=ext, tel=tel, tier=l_name)
            if flags["s"]["any_live"]:
                # roll the S tier back to the accepted boundary: recurrent
                # state from the draft's per-step copies (attention state
                # is positional: the host rewinds pos)
                with _NO_SPAN if tel is None else tel.lane(s_name, "verify"):
                    cfg = self.s.cfg
                    sel = model_zoo.select_stage(cfg, ext["staged"],
                                                 outs["l"]["keep"])
                    model_zoo.restore_stage(cfg, self.srt.pool.buffers, sel,
                                            tins["s"]["draft_live"])
        else:
            outs["s"] = self._ticks["s"](self.s.params, theta_t, tins["s"],
                                         flags["s"], self.local_srt.pool,
                                         tel=tel, tier=s_name)
            with act.use_mesh(self._l_mesh, self._l_cut):
                outs["l"] = self._ticks["l"](self._l_params, theta_t,
                                             tins["l"], flags["l"],
                                             self.lrt.pool, tel=tel,
                                             tier=l_name)
        if mesh is None:
            tree = {f"s.{k}": v for k, v in outs["s"].items()}
        else:
            packed, metas = engine_mod.pack_int32(outs["s"])
            tree = {"s": act.all_gather_dim(packed[None], mesh.group("data"),
                                            0)}
        tree.update({f"l.{k}": v for k, v in outs["l"].items()})
        if mesh is not None and self.validate:
            words = engine_mod.pack_int32(tree)[0]
            tree["check"] = act.all_gather_dim(_checksum(words)[None], None,
                                               0)
        if tel is not None:
            tel.mark("dispatch")
        fetched = engine_mod._host_fetch(tree)
        if tel is not None:
            tel.mark("host_fetch")
        self.counters.ticks += 1
        host = {"l": {k[2:]: v for k, v in fetched.items()
                      if k.startswith("l.")}}
        if mesh is None:
            s_host = {k[2:]: v for k, v in fetched.items()
                      if k.startswith("s.")}
            host["s"] = s_host if self.speculative else [s_host]
            return host
        self._staged = self._staged_next     # the write half turns readable
        if "check" in fetched and (fetched["check"] != fetched["check"][0]
                                   ).any():
            raise RuntimeError(
                f"mesh ranks diverged at tick {self.counters.ticks - 1}: "
                f"output checksums {fetched['check'].tolist()} differ, so "
                "the ranks' host decisions parted")
        host["s"] = [engine_mod.unpack_int32(row, metas)
                     for row in fetched["s"]]
        return host

    def _prepare_stage(self, l_queue, cur: int) -> None:
        """Stage up to ``lrt.admit_width`` head-of-queue escalations for
        the NEXT tick's L admit lane: their padded prompt tokens go into
        the staging buffer's write half in this tick's dispatch.  An
        escalation is staged again every tick until admitted (its row may
        move); the host keeps rid -> row for the ``ready`` gate."""
        t_rows, s_max = self._stage_tokens.shape
        tokens = np.zeros((t_rows, s_max), np.int32)
        nxt: Dict[int, int] = {}
        for i, adm in enumerate(l_queue):
            if i >= t_rows:
                break
            n = min(adm.bucket, s_max)
            tokens[i, :n] = adm.tokens[:n]
            nxt[adm.request.request_id] = i
        self._stage_tokens = tokens
        self._staged_next = nxt
        self._stage_wix = cur % 2

    def _stage_rows(self) -> Dict[str, np.ndarray]:
        """The staging operands of a mesh tick: the rows written at tick
        top, and for each L admission the row it was staged in last tick
        (the ``ready`` gate ensures it was)."""
        rows = np.zeros((self.lrt.admit_width,), np.int32)
        for row, slot in enumerate(self.lrt.admitted):
            rid = self.lrt.slot_req[slot].adm.request.request_id
            rows[row] = self._staged[rid]
        return {"t.tokens": self._stage_tokens, "t.row": rows}

    def _gauges(self, l_queue_len: int = 0) -> Dict[str, float]:
        """Per-tick telemetry gauges: host state the scheduler already
        holds, so sampling moves nothing on the device."""
        g: Dict[str, float] = {}
        for rt in (*self.srts, self.lrt):
            for k, v in rt.pool.gauges().items():
                g[f"{k}@{rt.name}"] = v
            g[f"busy_slots@{rt.name}"] = rt.busy
        g["l_queue_depth"] = l_queue_len
        if self._mesh is not None:
            # the staging buffer: rows readable this tick, the write half,
            # and the S replica count
            g["stage_occupancy"] = len(self._staged)
            g["stage_wix"] = self._stage_wix
            g["replicas"] = len(self.srts)
        if self._link is not None:
            g["esc_in_flight"] = self._link.pending
        if self._breaker is not None:
            g["breaker_state"] = self._breaker.state_id
        return g

    def _observe_tick(self, l_queue_len: int = 0) -> None:
        """End-of-tick observability: telemetry gauges (with the audit's
        aggregates), the SLO watchdog, the flight-recorder snapshot and its
        dump triggers.  One branch with every collector off."""
        tel, aud, wd, fr = self.tel, self.aud, self.wd, self.fr
        if tel is None and wd is None and fr is None:
            return
        tick = self.counters.ticks - 1       # the tick just dispatched
        gauges = self._gauges(l_queue_len)
        if aud is not None:
            gauges.update(aud.gauge_values())
        if tel is not None:
            tel.end_tick(gauges)
        breaches = [] if wd is None else \
            wd.evaluate(tick, tel=tel, audit=aud, gauges=gauges)
        if tel is not None:
            for b in breaches:
                tel.instant(f"slo_breach:{b['kind']}", **b)
        if fr is None:
            return
        # deterministic fields only: serve_time is wall clock and would
        # break the byte-equal dumps; a per-tier family (the lane graphs')
        # appears once a tier bumped it, as a copy
        counters = {k: dict(v) if isinstance(v, dict) else v
                    for k, v in self.stats.items()
                    if k != "serve_time" and not (isinstance(v, dict)
                                                  and not v)}
        snap: Dict[str, Any] = {"tick": tick, "gauges": gauges,
                                "counters": counters}
        if fr.include_timings and tel is not None and tel.ticks:
            snap["phase_seconds"] = {
                p: round(t1 - t0, 9)
                for p, t0, t1 in tel.ticks[-1].segments}
        fr.record(snap)
        for b in breaches:
            fr.trigger(f"slo_breach:{b['kind']}", tick, b)
        if self._breaker is not None \
                and self._breaker.opens > self._opens_seen:
            self._opens_seen = self._breaker.opens
            fr.trigger("breaker_open", tick,
                       {"opens": self._breaker.opens,
                        "opened_tick": self._breaker.opened_tick})

    def _check_pools(self, cur: int) -> None:
        """``validate=True``: both pools' invariants after the tick; a
        failure dumps the flight recorder before it re-raises."""
        if not self.validate:
            return
        try:
            for rt in (*self.srts, self.lrt):
                rt.pool.check_invariants()
        except AssertionError as e:
            if self.fr is not None:
                self.fr.trigger("invariant_failure", cur, {"error": str(e)})
            raise

    @torch.inference_mode()
    def run(self, queue: AdmissionQueue, *, theta: Optional[float] = None
            ) -> Dict[int, Dict[str, Any]]:
        """Drain ``queue`` through the slots; returns per-request records
        keyed by request_id: tokens / s_tokens / confidence / offloaded /
        served_remote / dropped / status / escalation_retries /
        queue_wait_ticks / esc_created_tick / ttft, as the reference's,
        plus the block accounting in speculative mode.  Every submitted
        request terminates with exactly one record whose ``status`` is one
        of ``faults.STATUSES``, under any fault schedule.
        ``stats['serve_time']`` brackets the whole drain once."""
        t0 = time.perf_counter()
        try:
            return self._run(queue, theta)
        finally:
            self.counters.serve_time += time.perf_counter() - t0

    def _theta(self, value: float) -> torch.Tensor:
        # filled on the device: no host->device copy to wait for
        return torch.full((), value, dtype=torch.float32, device=self.device)

    def _run(self, queue: AdmissionQueue, theta: Optional[float]
             ) -> Dict[int, Dict[str, Any]]:
        theta = float(self.hi.theta if theta is None else theta)
        theta_t = self._theta(theta)
        results: Dict[int, Dict[str, Any]] = {}
        tel = self.tel
        self._run_theta = theta
        self._eff_theta = theta

        if self.speculative:
            while len(queue) or self.srt.busy:
                if tel is not None:
                    tel.begin_tick(self.counters.ticks)
                self._try_admit_spec(queue, results)
                if tel is not None:
                    tel.mark("fault_tick")   # admission bookkeeping
                host = self._dispatch(theta_t)
                self._absorb_spec(host, results)
                self._check_pools(self.counters.ticks - 1)
                if tel is not None:
                    tel.mark("postprocess")
                self._observe_tick()
            return results

        theta_fail_t = self._theta(FAIL_LOCAL_THETA)
        # per-run fault state: run-relative tick 0 anchors here
        self._tick0 = self.counters.ticks
        self._link = EscalationLink(self.faults, self.policy)
        self._breaker = CircuitBreaker(self.policy)
        self._esc_meta = {}
        self._probe = None
        self._opens_seen = 0
        # the staging pipeline re-anchors per run: no half of an earlier
        # run's buffer is readable
        self._staged, self._staged_next = {}, {}
        ready = None if self._mesh is None else \
            (lambda adm: adm.request.request_id in self._staged)
        stall, idle = self._stall_limit(), 0
        l_queue: deque = deque()
        while (len(queue) or l_queue or any(rt.busy for rt in self.srts)
               or self.lrt.busy or self._link.pending):
            if tel is not None:
                tel.begin_tick(self.counters.ticks)
            cur = self.counters.ticks - self._tick0
            state = self._breaker.state_at(cur)
            if state == CircuitBreaker.OPEN:
                self.counters.breaker_open_ticks += 1
            elif state == CircuitBreaker.CLOSED:
                self._probe = None
            self._fault_tick(cur, l_queue, results)
            for rt in self.srts:
                self._try_admit(rt, queue,
                                on_give_up=lambda adm: self._reject(adm,
                                                                    results))
            self._drop_expired(l_queue, results, cur)
            # on a mesh, an escalation admits once its staged row is
            # readable: the +1 tick is the modelled ED->ES hop
            self._try_admit(self.lrt, l_queue, limit=self._l_admit_limit(cur),
                            on_give_up=lambda adm: self._l_give_up(adm, cur,
                                                                   results),
                            ready=ready)
            if self._mesh is not None:
                self._prepare_stage(l_queue, cur)
            for slot in range(self.lrt.num_slots):
                rec = self.lrt.slot_req[slot]
                if rec is None:
                    continue
                esc = self._esc_meta.get(rec.adm.request.request_id)
                if esc is not None and esc.l_admit_tick < 0:
                    esc.l_admit_tick = cur
                    if self._breaker.state == CircuitBreaker.HALF_OPEN \
                            and self._probe is None:
                        self._probe = esc.rid
            if tel is not None:
                tel.mark("fault_tick")   # fault machinery + admission
            s_busy = any(rt.busy for rt in self.srts)
            if not (len(queue) or l_queue or s_busy or self.lrt.busy
                    or self._link.pending):
                if tel is not None:
                    tel.drop_tick()
                break                  # everything left resolved host-side
            if s_busy or self.lrt.busy or self.lrt.admitted \
                    or any(rt.admitted for rt in self.srts):
                idle = 0
            else:
                # a pure timer tick: backoff / cooldown / fault window /
                # admission retry; bounded unless the schedule is not
                idle += 1
                if idle > stall:
                    if self.fr is not None:
                        self.fr.trigger("stall", cur, {
                            "idle_ticks": idle, "queue": len(queue),
                            "l_queue": len(l_queue),
                            "in_flight": self._link.pending})
                    raise RuntimeError(
                        f"scheduler stalled: {idle} consecutive idle ticks "
                        f"with work pending (queue={len(queue)}, "
                        f"l_queue={len(l_queue)}, "
                        f"in_flight={self._link.pending})")
            open_now = self._breaker.state == CircuitBreaker.OPEN
            self._eff_theta = FAIL_LOCAL_THETA if open_now else theta
            host = self._dispatch(theta_fail_t if open_now else theta_t)
            for rt, out in zip(self.srts, host["s"]):
                self._absorb(rt, out,
                             lambda rec: self._finish_s(rec, theta, results))
            self._absorb(self.lrt, host["l"],
                         lambda rec: self._finish_l(rec, results))
            self._check_pools(cur)
            if tel is not None:
                tel.mark("postprocess")
            self._observe_tick(len(l_queue))
        self.counters.esc_lost += self._link.lost
        self.counters.breaker_opens += self._breaker.opens
        return results

    # -- fault machinery (host-side; see serving/faults.py) -----------------

    def _stall_limit(self) -> int:
        """Upper bound on CONSECUTIVE idle (timer-only) ticks any bounded
        schedule + policy can produce; past it the run is genuinely stuck."""
        p = self.policy
        span = max([b for _, b in self.faults.outages + self.faults.spikes],
                   default=0)
        return (p.admit_retry_limit + p.breaker_cooldown_ticks
                + (p.max_retries + 2) * (p.ack_timeout_ticks
                                         + p.backoff_cap_ticks) + span + 64)

    def _l_admit_limit(self, cur: int) -> Optional[int]:
        """How many escalations L admission may take this tick: 0 while the
        L tier is paused (outage / spike / open breaker), 1 while half-open
        with no probe outstanding, unlimited when closed."""
        if self.faults.l_paused(cur):
            return 0
        state = self._breaker.state
        if state == CircuitBreaker.OPEN:
            return 0
        if state == CircuitBreaker.HALF_OPEN:
            return 0 if self._probe is not None else 1
        return None

    def _fault_tick(self, cur: int, l_queue: deque, results: Dict) -> None:
        """Advance the transport sim one tick: outage aborts first (busy L
        slots release their pages through ``KVPool.free``; later ticks
        reuse them in stream order), then arrivals / ack timeouts, then due
        resends (held while the breaker is open)."""
        link = self._link
        tel = self.tel
        if self.faults.in_outage(cur):
            for slot in range(self.lrt.num_slots):
                if self.lrt.slot_req[slot] is not None:
                    rec = self.lrt.release(slot)
                    if tel is not None:
                        tel.req_l_release(rec.adm.request.request_id,
                                          "outage_abort")
                    self._esc_failed(
                        self._esc_meta[rec.adm.request.request_id], cur,
                        results)
            while l_queue:
                adm = l_queue.popleft()
                self._esc_failed(self._esc_meta[adm.request.request_id],
                                 cur, results)
        arrived, failed = link.step(cur)
        for esc in arrived:
            if tel is not None:
                tel.req_esc_end(esc.rid, "arrived")
            l_queue.append(esc.adm)
        for esc in failed:
            self._esc_failed(esc, cur, results)
        if self._breaker.state != CircuitBreaker.OPEN:
            for esc in link.due_resends(cur):
                link.take(esc)
                if self._budget_expired(esc.adm):
                    self._degrade(esc, cur, results)  # too late to retry
                else:
                    link.send(esc, cur)
                    if tel is not None:
                        tel.req_esc_send(esc.rid, -1, esc.attempt)

    @staticmethod
    def _budget_expired(adm: AdmittedRequest) -> bool:
        budget = adm.request.latency_budget
        return (budget is not None
                and time.monotonic() - adm.submit_time > budget)

    def _esc_failed(self, esc, cur: int, results: Dict) -> None:
        """One escalation attempt failed: count it against the breaker, then
        retry with capped exponential backoff, or give up when retries are
        exhausted or the latency budget says the answer would come too
        late."""
        self._breaker.record_failure(cur)
        if self.tel is not None:
            self.tel.req_esc_end(esc.rid, "failed")
        if self._probe == esc.rid:
            self._probe = None
        if esc.attempt >= self.policy.max_retries \
                or self._budget_expired(esc.adm):
            self._degrade(esc, cur, results)
        else:
            self._link.schedule_retry(esc, cur)
            self.counters.esc_retries += 1

    def _degrade(self, esc, cur: int, results: Dict) -> None:
        """Give up on the escalation: the S-tier answer (already recorded)
        stands, flagged ``status='degraded_local'``."""
        self._esc_meta.pop(esc.rid, None)
        self.counters.degraded_local += 1
        rec = results[esc.rid]
        rec["status"] = "degraded_local"
        rec["escalation_retries"] = esc.attempt
        rec["queue_wait_ticks"] = max(cur - esc.created_tick, 0)
        if self.tel is not None:
            self.tel.req_terminal(esc.rid, rec)

    def _l_give_up(self, adm: AdmittedRequest, cur: int,
                   results: Dict) -> None:
        """L-tier admission starvation past the retry cap: the S answer
        exists, so degrade rather than reject."""
        esc = self._esc_meta.get(adm.request.request_id)
        if esc is not None:
            self._degrade(esc, cur, results)

    def _reject(self, adm: AdmittedRequest, results: Dict) -> None:
        """Bounded admission backpressure: after ``admit_retry_limit``
        fruitless ticks the request fails with ``status='rejected'``."""
        self.counters.requests += 1
        self.counters.rejected += 1
        warnings.warn(
            f"request {adm.request.request_id} rejected: admission failed "
            f"{adm.admit_retries} ticks running (bucket {adm.bucket} needs "
            "more free pages than the pool can produce) — raise num_pages / "
            "num_slots or shrink the prompt", RuntimeWarning, stacklevel=3)
        results[adm.request.request_id] = {
            "tokens": np.zeros((0,), np.int32),
            "s_tokens": np.zeros((0,), np.int32),
            "confidence": 0.0,
            "offloaded": False,
            "served_remote": False,
            "dropped": False,
            "status": "rejected",
            "escalation_retries": 0,
            "queue_wait_ticks": 0,
            "esc_created_tick": -1,
            "ttft": float("nan"),
        }
        if self.tel is not None:
            self.tel.req_terminal(adm.request.request_id,
                                  results[adm.request.request_id])

    # -- admission / completion -------------------------------------------

    def _try_admit(self, rt: _TierRuntime, queue, limit: Optional[int] = None,
                   on_give_up=None, ready=None) -> None:
        """Admit up to ``admit_width`` queued requests into free slots.
        ``queue`` is the AdmissionQueue (S tier) or the escalation deque
        (L tier).  ``limit`` caps this tick's admissions (0 = the L tier is
        paused; 1 = the half-open probe).  ``ready`` (mesh) gates on the
        staging pipeline: admission stops at the first head entry whose
        tokens are not yet readable from the staging buffer.  A request
        that keeps failing admission goes to ``on_give_up`` after
        ``RetryPolicy.admit_retry_limit`` fruitless ticks."""
        rt.admitted = []
        rt.plans = []
        if limit == 0:
            return
        tick = self.counters.ticks
        cap = rt.admit_width if limit is None else min(rt.admit_width, limit)
        admitted = 0
        while admitted < cap and len(queue):
            if rt.free_slot() is None:
                break
            if ready is not None and not ready(queue[0]):
                break
            adm = queue.popleft()
            steps = min(adm.request.max_new_tokens, self.max_new_tokens)
            slot = rt.admit(adm, steps, self.decode_block, tick)
            if slot is None:
                adm.admit_retries += 1
                if on_give_up is not None and \
                        adm.admit_retries > self.policy.admit_retry_limit:
                    on_give_up(adm)     # head cleared: try the next request
                    continue
                queue.appendleft(adm)   # no pages this tick: retry next tick
                break
            if self.tel is not None:
                self.tel.req_admitted(rt.name, slot, adm.request.request_id,
                                      adm.submit_time,
                                      chunked=bool(rt.chunk_left[slot]))
            admitted += 1

    def _try_admit_spec(self, queue, results: Dict) -> None:
        """Speculative admission: both tiers claim the SAME slot index for a
        request (the verify chunk addresses the L pool by the S slot's
        id) and prefill both caches through their admit lanes."""
        srt, lrt = self.srt, self.lrt
        srt.admitted, srt.plans = [], []
        lrt.admitted, lrt.plans = [], []
        tick = self.counters.ticks
        admitted = 0
        while admitted < srt.admit_width and len(queue):
            slot = srt.free_slot()
            if slot is None:
                break
            assert lrt.slot_req[slot] is None, "spec slot pairing broken"
            adm = queue.popleft()
            steps = min(adm.request.max_new_tokens, self.max_new_tokens)
            if srt.admit(adm, steps, self.decode_block, tick) is None:
                adm.admit_retries += 1
                if adm.admit_retries > self.policy.admit_retry_limit:
                    self._reject(adm, results)
                    continue
                queue.appendleft(adm)
                break
            if lrt.admit(adm, steps, self.decode_block, tick) is None:
                # roll the S-side admission back and retry next tick: drop
                # its same-tick prefix-index registrations first (their
                # pages will never be prefilled now), then free the slot
                if srt.admitted and srt.admitted[-1] == slot:
                    srt.admitted.pop()
                    srt.plans.pop()
                if srt.sharing:
                    srt.pool.retract(slot, adm.page_hashes, adm.full_hash,
                                     tick)
                srt.release(slot)
                adm.admit_retries += 1
                if adm.admit_retries > self.policy.admit_retry_limit:
                    self._reject(adm, results)
                    continue
                queue.appendleft(adm)
                break
            if self.tel is not None:
                self.tel.req_admitted("S", slot, adm.request.request_id,
                                      adm.submit_time,
                                      chunked=bool(srt.chunk_left[slot]))
            admitted += 1

    def _drop_expired(self, l_queue: deque, results: Dict,
                      cur: int = 0) -> None:
        """arXiv:2112.11413 drop policy: an escalation whose request has
        outlived its latency budget is dropped from the L queue; the S-tier
        answer (already recorded) stands, flagged ``dropped``.  A queued
        escalation holds no L-side resources, so nothing is released."""
        if not l_queue:
            return
        now = time.monotonic()
        kept: List[AdmittedRequest] = []
        while l_queue:
            adm = l_queue.popleft()
            budget = adm.request.latency_budget
            if budget is not None and now - adm.submit_time > budget:
                self.counters.dropped += 1
                esc = self._esc_meta.pop(adm.request.request_id, None)
                rec = results.get(adm.request.request_id)
                if rec is not None:
                    rec["dropped"] = True
                    rec["status"] = "dropped"
                    if esc is not None:
                        rec["escalation_retries"] = esc.attempt
                        rec["queue_wait_ticks"] = max(
                            cur - esc.created_tick, 0)
                    if self.tel is not None:
                        self.tel.req_terminal(adm.request.request_id, rec)
            else:
                kept.append(adm)
        l_queue.extend(kept)

    def _absorb_chunk(self, rt: _TierRuntime, out, emit: bool) -> None:
        """Advance the tick's scheduled chunk-prefill rows; finishing rows
        emit their chunk-sampled token 0 where ``emit`` (the S tier; the
        paired L tier in speculative mode only advances).  Where the tier
        shares partial prefixes, the full prompt pages a row completed enter
        the page index, visible from the next tick."""
        for row, (slot, keep, fin) in enumerate(rt.chunk_sched):
            if rt.registers:
                adm = rt.slot_req[slot].adm
                fed = int(rt.chunk_fed[slot])
                rt.pool.register_written(slot, adm.page_hashes, adm.bucket,
                                         fed, fed + keep, self.counters.ticks)
            rt.chunk_fed[slot] += keep
            rt.chunk_left[slot] -= keep
            if self.tel is not None:
                self.tel.req_chunk(rt.name, slot,
                                   rt.slot_req[slot].adm.request.request_id,
                                   fed=keep, keep=int(rt.chunk_left[slot]),
                                   tick=self.counters.ticks - 1,
                                   lane="chunk")
            if fin and emit:
                rec = rt.slot_req[slot]
                if self.aud is not None and not rec.done:
                    self.aud.decision(
                        rid=rec.adm.request.request_id, tier=rt.name,
                        tclass=rec.adm.request.tclass, kind="chunk",
                        conf=float(out["chunk_conf"][row]),
                        theta=self._eff_theta)
                rec.emit(out["chunk_tok"][row], out["chunk_conf"][row])

    def _absorb(self, rt: _TierRuntime, out: Dict[str, np.ndarray],
                finish) -> None:
        aud = self.aud
        for row, slot in enumerate(rt.admitted):
            rec = rt.slot_req[slot]
            if aud is not None and not rec.done:
                aud.decision(rid=rec.adm.request.request_id, tier=rt.name,
                             tclass=rec.adm.request.tclass, kind="admit",
                             conf=float(out["admit_conf"][row]),
                             theta=self._eff_theta)
            rec.emit(out["admit_tok"][row], out["admit_conf"][row])
        if self.chunk:
            self._absorb_chunk(rt, out, emit=True)
        k_steps = out["toks"].shape[0]
        for slot in range(rt.num_slots):
            rec = rt.slot_req[slot]
            if rec is None:
                continue
            if self.chunk and rt.chunk_left[slot] > 0:
                continue               # still chunk-prefilling: no decode
            for k in range(k_steps):
                if aud is not None and not rec.done:
                    aud.decision(rid=rec.adm.request.request_id,
                                 tier=rt.name,
                                 tclass=rec.adm.request.tclass,
                                 kind="decode",
                                 conf=float(out["confs"][k][slot]),
                                 theta=self._eff_theta)
                rec.emit(out["toks"][k][slot], out["confs"][k][slot])
            rt.last_tok[slot] = int(out["toks"][k_steps - 1][slot])
            rt.tok_idx[slot] += k_steps
            rt.pos[slot] += k_steps
            if self.tel is not None:
                self.tel.req_decode(rt.name, slot,
                                    rec.adm.request.request_id, k_steps,
                                    tick=self.counters.ticks - 1,
                                    lane="live")
            if rec.done:
                finish(rt.release(slot))

    def _absorb_spec(self, host: Dict, results: Dict) -> None:
        """Fused-cascade absorb: per decoding slot the L verify decided how
        many draft tokens stand (``accept``), which block input boundary
        both caches keep (``keep``) and what to emit (``n_emit`` of
        ``toks``).  The host rewinds positions by the rejected tail and
        asserts the rewind is COW-safe (``KVPool.truncate``)."""
        s, l = host["s"], host["l"]
        srt, lrt = self.srt, self.lrt
        k = self.decode_block
        for row, slot in enumerate(srt.admitted):
            srt.slot_req[slot].emit(s["admit_tok"][row], s["admit_conf"][row])
        if self.chunk:
            self._absorb_chunk(srt, s, emit=True)
            self._absorb_chunk(lrt, s, emit=False)
        for slot in range(srt.num_slots):
            rec = srt.slot_req[slot]
            if rec is None:
                continue
            if self.chunk and srt.chunk_left[slot] > 0:
                continue               # still chunk-prefilling: no decode
            n = int(l["n_emit"][slot])
            keep = int(l["keep"][slot])
            esc = bool(l["esc"][slot])
            rec.rounds.append((esc, n))
            self.counters.blocks += 1
            self.counters.drafted += k
            self.counters.accepted += int(l["accept"][slot])
            if esc:
                self.counters.escalated_blocks += 1
            rid = rec.adm.request.request_id
            if self.tel is not None:
                tick = self.counters.ticks - 1
                self.tel.req_decode("S", slot, rid, n, tick=tick,
                                    lane="live")
                if esc:
                    self.tel.req_l_verify(slot, rid,
                                          int(l["accept"][slot]), n,
                                          tick=tick, lane="verify")
            if self.aud is not None:
                # the block-level gate decision, and per emitted position
                # the verify lane's ground truth (L re-derived every drafted
                # position greedily, escalated or not); the rolled-back tail
                # is drafted again and would count twice
                tclass = rec.adm.request.tclass
                dc = l["draft_confs"][slot]
                mt = l["match"][slot]
                self.aud.decision(rid=rid, tier="S", tclass=tclass,
                                  kind="block", conf=float(dc[:k].min()),
                                  theta=self._eff_theta, offload=esc)
                for j in range(n):
                    self.aud.outcome(rid=rid, tier="L", tclass=tclass,
                                     conf=float(dc[j]),
                                     theta=self._eff_theta,
                                     ok=bool(mt[j]), kind="draft")
            for j in range(n):
                rec.emit(l["toks"][slot][j], l["confs"][slot][j])
            last = int(l["toks"][slot][max(n - 1, 0)])
            for rt in (srt, lrt):
                rt.pos[slot] += keep
                rt.tok_idx[slot] += n
                rt.last_tok[slot] = last
                if keep < k:
                    # the rejected tail is rolled back: the rewound write
                    # position can never reach a shared page
                    rt.pool.truncate(slot, int(rt.pos[slot]))
            if rec.done:
                self._finish_spec(srt.release(slot), results)
                lrt.release(slot)

    def _finish_s(self, rec: _Active, theta: float, results: Dict) -> None:
        """S decode finished: record the local answer, and when the gate
        fires send the escalation across the link.  ``offloaded`` records
        the intent (``conf < theta`` with the real theta)."""
        conf = float(np.mean(np.asarray(rec.confs, np.float32)))
        rid = rec.adm.request.request_id
        self.counters.requests += 1
        if self.aud is not None:
            # the request-level decision at the REAL theta, as
            # ``offloaded``: fail-local degradation shows in ``status``
            self.aud.decision(rid=rid, tier="S",
                              tclass=rec.adm.request.tclass, kind="request",
                              conf=conf, theta=theta)
        results[rid] = {
            "tokens": np.asarray(rec.tokens, np.int32),
            "s_tokens": np.asarray(rec.tokens, np.int32),
            "confidence": conf,
            "offloaded": conf < theta,
            "served_remote": False,
            "dropped": False,
            "status": "ok",
            "escalation_retries": 0,
            "queue_wait_ticks": 0,
            "esc_created_tick": -1,      # -1 = never escalated
            "ttft": rec.ttft,
        }
        if conf >= theta:
            if self.tel is not None:      # never escalates: final status
                self.tel.req_terminal(rid, results[rid])
            return
        self.counters.offloaded += 1
        cur = self.counters.ticks - self._tick0
        results[rid]["esc_created_tick"] = cur
        esc = Escalation(rec.adm, rid, cur)
        if self._breaker.state == CircuitBreaker.OPEN:
            # fail-local: nothing crosses the link, the request degrades
            self._degrade(esc, cur, results)
            return
        rec.adm.admit_retries = 0   # L admission gets a fresh retry budget
        self._esc_meta[rid] = esc
        self._link.send(esc, cur)
        if self.tel is not None:
            self.tel.req_esc_send(rid, -1, esc.attempt)

    def _finish_l(self, rec: _Active, results: Dict) -> None:
        rid = rec.adm.request.request_id
        out = results[rid]
        out["tokens"] = np.asarray(rec.tokens, np.int32)
        out["served_remote"] = True
        out["status"] = "ok"
        if self.aud is not None:
            # one agreement sample per completed escalation: did the S
            # answer match what L produced?
            st, lt = out["s_tokens"], out["tokens"]
            m = min(len(st), len(lt))
            ok = m > 0 and bool(np.array_equal(st[:m], lt[:m]))
            self.aud.outcome(rid=rid, tier="L",
                             tclass=rec.adm.request.tclass,
                             conf=out["confidence"], theta=self._run_theta,
                             ok=ok, kind="l_agree")
        esc = self._esc_meta.pop(rid, None)
        if esc is not None:
            cur = self.counters.ticks - self._tick0
            out["escalation_retries"] = esc.attempt
            out["queue_wait_ticks"] = max(
                (esc.l_admit_tick if esc.l_admit_tick >= 0 else cur)
                - esc.created_tick, 0)
            self._breaker.record_success()
            if self._probe == rid:
                self._probe = None
        if self.tel is not None:
            self.tel.req_terminal(rid, out)

    def _finish_spec(self, rec: _Active, results: Dict) -> None:
        rid = rec.adm.request.request_id
        self.counters.requests += 1
        escalated = sum(1 for esc, _ in rec.rounds if esc)
        if escalated:
            self.counters.offloaded += 1
        conf = float(np.mean(np.asarray(rec.confs, np.float32))) \
            if rec.confs else 1.0
        if self.aud is not None:
            self.aud.decision(rid=rid, tier="S",
                              tclass=rec.adm.request.tclass, kind="request",
                              conf=conf, theta=self._run_theta,
                              offload=escalated > 0)
        results[rid] = {
            "tokens": np.asarray(rec.tokens, np.int32),
            "s_tokens": np.asarray(rec.tokens, np.int32),
            "confidence": conf,
            "offloaded": escalated > 0,
            "served_remote": False,
            "dropped": False,
            "status": "ok",
            "escalation_retries": 0,
            "queue_wait_ticks": 0,
            "esc_created_tick": -1,      # the fused cascade has no L queue
            "ttft": rec.ttft,
            "rounds": list(rec.rounds),
            "blocks": len(rec.rounds),
            "escalated_blocks": escalated,
        }
        if self.tel is not None:
            self.tel.req_terminal(rid, results[rid])
