"""HI serving engine: the paper's ED/ES cascade over LM requests (drain path).

The S tier (a reduced variant of the same architecture) prefills and decodes
every request of a drained batch; each step's logits go through the fused
``hi_gate`` kernel; a request escalates iff its mean confidence is below
theta; the static-capacity router gathers the escalations for the L tier,
which generates them; the results are scatter-merged.

Device residency.  Everything between the two tiers stays on the card:
confidence mean, threshold, route, gather, scatter-merge and agreement.
Nothing in the hot path reads a device value on the host (no ``.item()``,
no python ``if`` on a tensor); theta is a 0-d device tensor that the
``hi_gate`` kernel reads through a pointer.  The host synchronises exactly
once per :meth:`HIEngine.serve`, after the cascade, through the
module-level :func:`_host_fetch` (tests monkeypatch it to count).

Cache buffers.  Each (batch, bucket) shape gets its pair of tier caches
once; later calls overwrite them in place (the reference donates its
buffers to the same end).  ``stats["cache_allocs"]`` counts the
allocations.

Numerics.  TF32 is off for matmuls and cuDNN (:class:`HIEngine` sets
both): float32 products stay float32, as in the reference.

Sampling.  ``temperature`` (engine-wide, default 0) > 0 samples each
token under the reference's per-request threefry keys
(``sampler.request_keys``: the request's seed and the token's index), so a
request's continuation equals the continuous scheduler's token for token;
at 0 decoding is greedy and builds no keys.

The legacy path.  :meth:`HIEngine.serve_legacy` is the reference's
pre-batched-prefill baseline, kept slow on purpose: a per-token
``decode_step`` prefill and greedy decode per tier (``_decode_loop``),
the plain confidence metric, the route on the host, one host sync per
tier.  The one-fetch contract does not apply to it.

Continuous serving.  :meth:`HIEngine.serve_stream` serves requests through
``scheduler.ContinuousScheduler``: slot-level admission over the paged KV
pools, prefix sharing and chunked prefill, the speculative draft-verify
lane, seeded transport faults with retries and the circuit breaker, and the
host-side collectors (telemetry, gate audit, SLO watchdog, flight
recorder), with one ``_host_fetch`` per tick.

Counters.  ``stats`` is a dict view over the engine's typed counters
(``telemetry.EngineStatsView``): the keys the scheduler also counts read
the live scheduler's counters, so the engine's totals and the scheduler's
cannot diverge.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import HIConfig, ModelConfig
from repro_torch.core import router as router_mod
from repro_torch.core.confidence import confidence
from repro_torch.kernels import ops
from repro_torch.models import model_zoo
from repro_torch.serving import sampler
from repro_torch.serving.telemetry import EngineCounters, EngineStatsView

KV_DTYPE = torch.bfloat16
RESULT_KEYS = ("tokens", "s_tokens", "confidence", "offloaded",
               "served_remote")


def disable_tf32() -> None:
    """Keep float32 matmuls and convolutions in full float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def pack_int32(tree: Dict[str, torch.Tensor]):
    """Every tensor of ``tree`` in one flat int32 tensor on its device
    (float32 bit-cast, bool and int converted; token ids fit), and what
    :func:`unpack_int32` needs to undo it on the host."""
    parts, metas = [], []
    for name, t in tree.items():
        if t.dtype == torch.float32:
            flat = t.contiguous().view(torch.int32)
        else:
            flat = t.to(torch.int32)
        parts.append(flat.reshape(-1))
        metas.append((name, t.dtype, tuple(t.shape)))
    return torch.cat(parts), metas


def unpack_int32(buf: np.ndarray, metas) -> Dict[str, np.ndarray]:
    """:func:`pack_int32`'s tree from its buffer on the host: float32
    stays float32, bool stays bool, integers become int32, as the
    reference returns them."""
    out, at = {}, 0
    for name, dtype, shape in metas:
        n = int(np.prod(shape, dtype=np.int64))
        seg = buf[at:at + n].reshape(shape)
        at += n
        if dtype == torch.float32:
            out[name] = seg.view(np.float32)
        elif dtype == torch.bool:
            out[name] = seg.astype(bool)
        else:
            out[name] = seg
    return out


def _host_fetch(tree: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The engine's single device->host copy: ``tree`` packed into one
    int32 buffer on its device (:func:`pack_int32`), the buffer crosses
    once, and the host unpacks it."""
    buf, metas = pack_int32(tree)
    return unpack_int32(buf.cpu().numpy(), metas)


@dataclass
class TierModel:
    cfg: ModelConfig
    params: Any


def _decode_loop(params, cfg: ModelConfig, tokens: torch.Tensor,
                 cache_len: int, steps: int, metric: str):
    """LEGACY path: token-by-token prefill + greedy decode, on the tokens'
    device: ``S + steps`` ``decode_step`` calls over a fresh bf16 cache, the
    plain confidence metric per generated token.  Returns (generated
    (B, steps) int64, mean confidence (B,))."""
    b, s = tokens.shape
    cache = model_zoo.init_cache(cfg, b, cache_len, KV_DTYPE, tokens.device)
    for t in range(s):
        logits, cache = model_zoo.decode_step(params, cfg, tokens[:, t:t + 1],
                                              cache)
    toks, confs = [], []
    for _ in range(steps):
        confs.append(confidence(logits, metric))
        tok = sampler.greedy(logits)
        logits, cache = model_zoo.decode_step(params, cfg, tok[:, None], cache)
        toks.append(tok)
    return torch.stack(toks, dim=1), torch.stack(confs).mean(dim=0)


def _generate(params, cfg: ModelConfig, tokens: torch.Tensor, cache, *,
              steps: int, metric: str, theta: torch.Tensor,
              seeds: torch.Tensor = None, temperature: float = 0.0):
    """Batched prefill + ``steps`` decode steps, all on the tokens' device.

    ``cache`` is overwritten in place.  Each step runs ``hi_gate`` on the
    current logits (its confidence feeds the mean), picks the token and
    decodes it, so a call makes ``steps`` hi_gate launches and ``steps``
    decode steps; the last step's logits are computed and left unused, as in
    the reference.  The token is greedy at ``temperature`` <= 0, else drawn
    under ``request_keys(seeds, i)`` at step i.  Returns (generated
    (B, steps) int64, mean confidence (B,), cache)."""
    logits, cache = model_zoo.prefill(params, cfg, tokens, cache)
    toks, confs = [], []
    for i in range(steps):
        confs.append(ops.hi_gate(logits, theta, metric)[0])
        if temperature > 0:
            tok = sampler.sample(sampler.request_keys(seeds, i), logits,
                                 temperature)
        else:
            tok = sampler.greedy(logits)
        logits, cache = model_zoo.decode_step(params, cfg, tok[:, None], cache)
        toks.append(tok)
    return torch.stack(toks, dim=1), torch.stack(confs).mean(dim=0), cache


def _make_cascade(s_cfg: ModelConfig, l_cfg: ModelConfig, hi: HIConfig,
                  steps: int, capacity: int):
    """The S->L cascade for one (batch, bucket) shape.  Everything between
    the two tier forwards stays on the device; the caller fetches the
    result dict once, at the end."""

    def cascade(s_params, l_params, tokens, theta, s_cache, l_cache,
                temperature=0.0, seeds=None):
        s_toks, s_conf, s_cache = _generate(
            s_params, s_cfg, tokens, s_cache, steps=steps, metric=hi.metric,
            theta=theta, seeds=seeds, temperature=temperature)
        offload = s_conf < theta
        decision = router_mod.route(offload, s_conf, capacity)
        complex_tokens = router_mod.gather(tokens, decision)
        l_toks, _, l_cache = _generate(
            l_params, l_cfg, complex_tokens, l_cache, steps=steps,
            metric=hi.metric, theta=theta,
            seeds=None if seeds is None else seeds[decision.indices],
            temperature=temperature)
        out = {
            "tokens": router_mod.scatter_merge(s_toks, l_toks, decision),
            "s_tokens": s_toks,
            "confidence": s_conf,
            "offloaded": decision.offload_mask,
            "served_remote": decision.served_remote,
            "dropped": decision.dropped,
            "l_indices": decision.indices,
            "l_valid": decision.valid,
            "l_agree": router_mod.agreement(s_toks, l_toks, decision),
        }
        return out, s_cache, l_cache

    return cascade


class HIEngine:
    """Two-tier cascade engine with a device-resident hot path.

    ``online_policy`` (paper ref [27]): when set, theta is tuned online from
    the L tier's feedback on offloaded requests (S/L agreement is the
    correctness proxy) and the engine uses ``policy.theta`` instead of the
    static ``hi.theta``.  Theta enters the kernels as a device tensor, so
    moving it costs nothing on the card.

    ``temperature`` > 0 makes ``serve`` sample every token
    (``serve_legacy`` stays greedy, as the reference's does) and is the
    temperature of ``serve_stream``'s requests that set none.

    The device is the one the tier params live on.
    """

    def __init__(self, s_tier: TierModel, l_tier: TierModel, hi: HIConfig,
                 cache_len: int = 128, max_new_tokens: int = 8,
                 online_policy=None, temperature: float = 0.0):
        disable_tf32()
        self.s = s_tier
        self.l = l_tier
        self.hi = hi
        self.online_policy = online_policy
        self.cache_len = cache_len
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.device = s_tier.params["embed"].device
        # (batch, bucket) -> [cascade fn, s_cache, l_cache]
        self._buffers: Dict[Tuple[int, int], list] = {}
        self._stream = None           # (scheduler key, ContinuousScheduler)
        self.counters = EngineCounters()
        self.stats: EngineStatsView = EngineStatsView(self.counters)

    def _entry(self, b: int, s: int) -> list:
        """The cascade and the tier caches for a (batch, bucket) shape,
        allocated once."""
        key = (b, s)
        ent = self._buffers.get(key)
        if ent is not None:
            return ent
        if s + self.max_new_tokens > self.cache_len:
            raise ValueError(
                f"bucket {s} + max_new_tokens {self.max_new_tokens} exceeds "
                f"cache_len {self.cache_len}")
        cap = router_mod.capacity_for(b, self.hi.capacity_factor)
        fn = _make_cascade(self.s.cfg, self.l.cfg, self.hi,
                           self.max_new_tokens, cap)
        s_cache = model_zoo.init_cache(self.s.cfg, b, self.cache_len,
                                       KV_DTYPE, self.device)
        l_cache = model_zoo.init_cache(self.l.cfg, cap, self.cache_len,
                                       KV_DTYPE, self.device)
        self.stats["cache_allocs"] += 1
        ent = [fn, s_cache, l_cache]
        self._buffers[key] = ent
        return ent

    @torch.inference_mode()
    def serve(self, tokens: np.ndarray,
              seeds: np.ndarray = None) -> Dict[str, np.ndarray]:
        """tokens: (B, S) prompt batch -> generations + offload accounting.

        One device->host copy per call, after the full cascade, through
        ``_host_fetch``.  ``seeds`` (B,) per-request sampling seeds, read
        when ``self.temperature > 0`` (typically the request ids, so that
        sampled continuations match the continuous path's); zeros if
        None."""
        b, s = tokens.shape
        ent = self._entry(b, s)
        theta = torch.tensor(
            self.online_policy.theta if self.online_policy is not None
            else self.hi.theta, dtype=torch.float32, device=self.device)
        t0 = time.perf_counter()
        dev_tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.int64,
                                     device=self.device)
        dev_seeds = None
        if self.temperature > 0:
            dev_seeds = torch.as_tensor(
                np.zeros((b,), np.int32) if seeds is None
                else np.asarray(seeds, np.int32), device=self.device)
        out, ent[1], ent[2] = ent[0](
            self.s.params, self.l.params, dev_tokens, theta, ent[1], ent[2],
            temperature=float(self.temperature), seeds=dev_seeds)
        host = _host_fetch(out)       # the single device->host sync point
        t1 = time.perf_counter()

        if self.online_policy is not None:
            served = host["l_valid"]
            if served.any():
                self.online_policy.update(
                    host["confidence"][host["l_indices"][served]],
                    host["l_agree"][served])

        self.stats["requests"] += b
        self.stats["offloaded"] += int(host["offloaded"].sum())
        self.stats["dropped"] += int(host["dropped"])
        self.stats["serve_time"] += t1 - t0
        return {k: host[k] for k in RESULT_KEYS}

    @torch.inference_mode()
    def serve_legacy(self, tokens: np.ndarray) -> Dict[str, np.ndarray]:
        """The reference's pre-batched-prefill path: a per-token prefill and
        greedy decode per tier (:func:`_decode_loop`), the route on the
        host, and one host sync per tier.  The ``legacy`` baseline that
        ``serve`` is measured against; not used in production."""
        b = tokens.shape[0]
        cap = router_mod.capacity_for(b, self.hi.capacity_factor)
        steps, metric = self.max_new_tokens, self.hi.metric
        t0 = time.perf_counter()
        dev_tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.int64,
                                     device=self.device)
        s_out, s_conf = _decode_loop(self.s.params, self.s.cfg, dev_tokens,
                                     self.cache_len, steps, metric)
        s_out, s_conf = s_out.cpu(), s_conf.cpu()       # host sync 1
        theta = (self.online_policy.theta if self.online_policy is not None
                 else self.hi.theta)
        offload = s_conf < theta
        decision = router_mod.route(offload, s_conf, cap)
        complex_tokens = dev_tokens[decision.indices.to(self.device)]
        l_out, _ = _decode_loop(self.l.params, self.l.cfg, complex_tokens,
                                self.cache_len, steps, metric)
        l_out = l_out.cpu()                              # host sync 2
        merged = router_mod.scatter_merge(s_out, l_out, decision)
        t1 = time.perf_counter()
        if self.online_policy is not None:
            served_idx = decision.indices[decision.valid]
            if len(served_idx):
                agree = (s_out[served_idx]
                         == l_out[decision.valid]).all(dim=-1)
                self.online_policy.update(s_conf[served_idx].numpy(),
                                          agree.numpy())
        self.stats["requests"] += b
        self.stats["offloaded"] += int(offload.sum())
        self.stats["dropped"] += int(decision.dropped)
        self.stats["serve_time"] += t1 - t0
        return {
            "tokens": merged.to(torch.int32).numpy(),
            "s_tokens": s_out.to(torch.int32).numpy(),
            "confidence": s_conf.numpy(),
            "offloaded": decision.offload_mask.numpy(),
            "served_remote": decision.served_remote.numpy(),
        }

    def serve_stream(self, requests, *, buckets=(32, 64), num_slots: int = 8,
                     l_slots: int = None, page_size: int = 16,
                     admit_width: int = None, decode_block: int = 4,
                     prefix_sharing: bool = True, prefix_entries: int = None,
                     chunk_prefill: bool = False, chunk_size: int = 8,
                     chunk_width: int = 2, speculative: bool = False,
                     kv_dtype: str = "bf16", mesh=None, faults=None,
                     retry=None, validate: bool = False, telemetry=None,
                     audit=None, watchdog=None,
                     flight_recorder=None) -> Dict[int, Dict[str, Any]]:
        """Continuous serving: ``requests`` (``batcher.Request``s) go through
        slot-level admission over the paged KV pools instead of drained
        (B, bucket) batches.  The reference's signature and scheduler cache
        key: a scheduler (with its pools and prefix indexes) persists across
        calls with the same configuration, so prefix reuse is cross-call.

        Requests are bucketized by the drain path's ladder, so greedy outputs
        equal ``serve``'s on the same traffic; per-request
        ``max_new_tokens`` / ``eos_id`` / ``latency_budget`` are honoured.
        ``prefix_sharing`` (default on) aliases cached prompt prefixes
        (refcounted, copy-on-write) and restores repeated prompts without
        prefill (``stats['prefill_tokens_saved']``); ``chunk_prefill``
        feeds prompts longer than ``chunk_size`` through the chunk lane.
        ``validate=True`` checks both pools' invariants after every tick.
        ``stats['stream_compiles']`` counts scheduler builds (ROADMAP: CUDA
        graph captures later).

        ``kv_dtype='int8'`` stores both tiers' pages as int8 with per-page,
        per-head float32 scales (about half the bf16 pool's bytes for the
        dense family; the recurrent state does not shrink).

        ``speculative`` fuses the S->L draft-verify token cascade into the
        tick (``serving/token_cascade.py`` is its host oracle): the S tier
        drafts ``decode_block`` tokens per slot, a block whose minimum
        hi_gate confidence clears theta is accepted at S-tier cost, the
        rest get one batched L verify chunk with longest-prefix acceptance
        and an in-tick rollback of the rejected tail.  Greedy-only, as in
        the reference: a request or an engine with temperature > 0
        raises.

        ``faults`` (a ``serving.faults.FaultSchedule``) injects seeded
        transport faults on the S->L escalation path (delivery delay, loss,
        L outage windows, latency spikes) and ``retry`` (a
        ``RetryPolicy``) sets the backoff, the circuit breaker (open =
        fail-local: the L queue pauses and the tick's theta operand drops
        to ``FAIL_LOCAL_THETA``) and the admission retry cap.  Every record
        carries ``status`` in {``ok``, ``degraded_local``, ``dropped``,
        ``rejected``}; faults never change a tensor shape.  Speculative
        mode has no L queue: an active schedule there raises.

        ``telemetry`` (``serving.telemetry.Telemetry``), ``audit``
        (``serving.audit.GateAudit``), ``watchdog``
        (``serving.audit.SLOWatchdog``) and ``flight_recorder``
        (``serving.flight_recorder.FlightRecorder``) install the host-side
        collectors for this call: span trees and tick-phase times, the
        per-decision gate audit, once-per-tick SLO checks, and the
        tick-snapshot ring with its postmortem dumps.  They read what the
        tick's one fetch brought back and add no device sync; outputs are
        token for token those with the collectors off.

        Requests sample at their own ``temperature`` or, where that is 0,
        the engine's, under per-request keys: sampled outputs equal
        ``serve``'s on the same bucketized traffic with the request ids as
        seeds.

        ``mesh`` (a ``launch/mesh.Mesh`` with axes ``("data", "model")``)
        serves on a device mesh, SPMD: every rank of the mesh calls
        ``serve_stream`` with the same requests on an engine built from
        the same seed.  The S tier runs ``mesh.shape["data"]`` replicas,
        one per ``data`` row; the L tier runs tensor parallel over
        ``model``; escalated prompts cross through the staging buffer, one
        tick late (``scheduler.py``).  Every rank returns every record.
        A (1, 1) mesh gives the single-device tokens, statuses and
        offloads bitwise.  Latency budgets are read from each rank's own
        clock, so a mesh of more than one rank refuses requests that set
        one; ``speculative`` with a mesh raises, as in the reference.

        Returns per-request result records keyed by request_id."""
        from repro_torch.serving.batcher import AdmissionQueue
        from repro_torch.serving.faults import NO_FAULTS, RetryPolicy
        from repro_torch.serving.scheduler import ContinuousScheduler

        requests = list(requests)
        if speculative:
            if self.temperature > 0:
                raise NotImplementedError(
                    "speculative serving is greedy-only: engine temperature "
                    f"{self.temperature} > 0 requires rejection sampling "
                    "(the reference's refusal; future work)")
            hot = [r.request_id for r in requests if r.temperature > 0]
            if hot:
                raise NotImplementedError(
                    "speculative serving is greedy-only: requests "
                    f"{hot} set temperature > 0, which requires rejection "
                    "sampling (the reference's refusal; future work)")
        key = (tuple(sorted(buckets)), num_slots, l_slots, page_size,
               admit_width, decode_block, prefix_sharing, prefix_entries,
               chunk_prefill, chunk_size, chunk_width, speculative, kv_dtype,
               None if mesh is None else id(mesh))
        if self._stream is None or self._stream[0] != key:
            sched = ContinuousScheduler(
                self.s, self.l, self.hi, max_prompt_len=max(buckets),
                max_new_tokens=self.max_new_tokens, num_slots=num_slots,
                l_slots=l_slots, page_size=page_size,
                admit_width=admit_width, decode_block=decode_block,
                prefix_sharing=prefix_sharing,
                prefix_entries=prefix_entries,
                chunk_prefill=chunk_prefill, chunk_size=chunk_size,
                chunk_width=chunk_width, speculative=speculative,
                kv_dtype=kv_dtype, mesh=mesh, temperature=self.temperature)
            self._stream = (key, sched)
            self.stats["stream_compiles"] += sched.stats["compiles"]
        sched = self._stream[1]
        if sched.ranks > 1:
            timed = [r.request_id for r in requests
                     if r.latency_budget is not None]
            if timed:
                raise ValueError(
                    f"requests {timed} set latency_budget: each rank of a "
                    f"{sched.ranks}-rank mesh would read its own clock and "
                    "the ranks' host decisions would part")
        # the engine's totals read this scheduler's counters live (a
        # replaced scheduler's totals fold into the base first)
        self.stats.attach(sched)
        sched.set_default_temperature(self.temperature)
        sched.set_audit(audit)
        sched.set_telemetry(telemetry)
        sched.set_watchdog(watchdog)
        sched.set_flight_recorder(flight_recorder)
        sched.set_faults(faults if faults is not None else NO_FAULTS,
                         retry if retry is not None else RetryPolicy(),
                         validate)
        queue = AdmissionQueue(buckets=buckets,
                               page_size=page_size if prefix_sharing else None)
        for r in requests:
            queue.submit(r)
        theta = (self.online_policy.theta if self.online_policy is not None
                 else self.hi.theta)
        return sched.run(queue, theta=theta)

    def summary(self) -> Dict[str, float]:
        n = max(self.stats["requests"], 1)
        return {**self.stats,
                "offload_frac": self.stats["offloaded"] / n,
                "drop_frac": self.stats["dropped"] / n}


def build_engine(cfg: ModelConfig, hi: HIConfig, *, seed: int = 0,
                 cache_len: int = 128,
                 max_new_tokens: int = 8,
                 device: str = "cuda",
                 temperature: float = 0.0) -> HIEngine:
    """An S/L cascade for one architecture: L = ``cfg``, S = its
    ``s_variant``, random params from a seeded ``torch.Generator`` on
    ``device`` (float32 params, bf16 KV cache).  ``device`` defaults to the
    card; the CPU is used only when asked for."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA device "
                           "is available")
    gen = torch.Generator(device=dev).manual_seed(seed)
    s_cfg = cfg.s_variant(hi.s_scale)
    l_params = model_zoo.init_params(gen, cfg)
    s_params = model_zoo.init_params(gen, s_cfg)
    return HIEngine(TierModel(s_cfg, s_params), TierModel(cfg, l_params), hi,
                    cache_len=cache_len, max_new_tokens=max_new_tokens,
                    temperature=temperature)
