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

Decoding is greedy: the reference's temperature sampling is not ported
(see ``sampler.py``), so the engine takes no temperature.  ``serve_legacy``
and ``serve_stream`` of the reference are not ported yet (ROADMAP Queue A
items 4 and 5).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import HIConfig, ModelConfig
from repro_torch.core import router as router_mod
from repro_torch.kernels import ops
from repro_torch.models import model_zoo
from repro_torch.serving import sampler

KV_DTYPE = torch.bfloat16
RESULT_KEYS = ("tokens", "s_tokens", "confidence", "offloaded",
               "served_remote")


def disable_tf32() -> None:
    """Keep float32 matmuls and convolutions in full float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _host_fetch(tree: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The engine's single device->host copy.

    Every tensor of ``tree`` is packed into one int32 buffer on its device
    (float32 bit-cast, bool and int converted), the buffer crosses once, and
    the host unpacks it: float32 stays float32, bool stays bool, integers
    become int32 (token ids fit), as the reference returns them."""
    parts, metas = [], []
    for name, t in tree.items():
        if t.dtype == torch.float32:
            flat = t.contiguous().view(torch.int32)
        else:
            flat = t.to(torch.int32)
        parts.append(flat.reshape(-1))
        metas.append((name, t.dtype, tuple(t.shape)))
    buf = torch.cat(parts).cpu().numpy()
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


@dataclass
class TierModel:
    cfg: ModelConfig
    params: Any


def _generate(params, cfg: ModelConfig, tokens: torch.Tensor, cache, *,
              steps: int, metric: str, theta: torch.Tensor):
    """Batched prefill + ``steps`` decode steps, all on the tokens' device.

    ``cache`` is overwritten in place.  Each step runs ``hi_gate`` on the
    current logits (its confidence feeds the mean), picks the greedy token
    and decodes it, so a call makes ``steps`` hi_gate launches and ``steps``
    decode steps; the last step's logits are computed and left unused, as in
    the reference.  Returns (generated (B, steps) int64, mean confidence (B,),
    cache)."""
    logits, cache = model_zoo.prefill(params, cfg, tokens, cache)
    toks, confs = [], []
    for _ in range(steps):
        confs.append(ops.hi_gate(logits, theta, metric)[0])
        tok = sampler.greedy(logits)
        logits, cache = model_zoo.decode_step(params, cfg, tok[:, None], cache)
        toks.append(tok)
    return torch.stack(toks, dim=1), torch.stack(confs).mean(dim=0), cache


def _make_cascade(s_cfg: ModelConfig, l_cfg: ModelConfig, hi: HIConfig,
                  steps: int, capacity: int):
    """The S->L cascade for one (batch, bucket) shape.  Everything between
    the two tier forwards stays on the device; the caller fetches the
    result dict once, at the end."""

    def cascade(s_params, l_params, tokens, theta, s_cache, l_cache):
        s_toks, s_conf, s_cache = _generate(
            s_params, s_cfg, tokens, s_cache, steps=steps, metric=hi.metric,
            theta=theta)
        offload = s_conf < theta
        decision = router_mod.route(offload, s_conf, capacity)
        complex_tokens = router_mod.gather(tokens, decision)
        l_toks, _, l_cache = _generate(
            l_params, l_cfg, complex_tokens, l_cache, steps=steps,
            metric=hi.metric, theta=theta)
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

    The device is the one the tier params live on.
    """

    def __init__(self, s_tier: TierModel, l_tier: TierModel, hi: HIConfig,
                 cache_len: int = 128, max_new_tokens: int = 8,
                 online_policy=None):
        disable_tf32()
        self.s = s_tier
        self.l = l_tier
        self.hi = hi
        self.online_policy = online_policy
        self.cache_len = cache_len
        self.max_new_tokens = max_new_tokens
        self.device = s_tier.params["embed"].device
        # (batch, bucket) -> [cascade fn, s_cache, l_cache]
        self._buffers: Dict[Tuple[int, int], list] = {}
        self.stats: Dict[str, float] = {
            "requests": 0, "offloaded": 0, "dropped": 0, "serve_time": 0.0,
            "cache_allocs": 0}

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
    def serve(self, tokens: np.ndarray) -> Dict[str, np.ndarray]:
        """tokens: (B, S) prompt batch -> generations + offload accounting.

        One device->host copy per call, after the full cascade, through
        ``_host_fetch``."""
        b, s = tokens.shape
        ent = self._entry(b, s)
        theta = torch.tensor(
            self.online_policy.theta if self.online_policy is not None
            else self.hi.theta, dtype=torch.float32, device=self.device)
        t0 = time.perf_counter()
        dev_tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.int64,
                                     device=self.device)
        out, ent[1], ent[2] = ent[0](
            self.s.params, self.l.params, dev_tokens, theta, ent[1], ent[2])
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

    def summary(self) -> Dict[str, float]:
        n = max(self.stats["requests"], 1)
        return {**self.stats,
                "offload_frac": self.stats["offloaded"] / n,
                "drop_frac": self.stats["dropped"] / n}


def build_engine(cfg: ModelConfig, hi: HIConfig, *, seed: int = 0,
                 cache_len: int = 128,
                 max_new_tokens: int = 8,
                 device: str = "cuda") -> HIEngine:
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
                    cache_len=cache_len, max_new_tokens=max_new_tokens)
