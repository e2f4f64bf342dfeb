"""The system under test: the PyTorch port's HI engine (``repro_torch``),
driven through ``HIEngine.serve_stream``.

Everything of the benchmark that touches the program is here: building
the engine around the benchmark's weights, serving a wave, and tallying
the work of the two paged attention kernels from their arguments.  The
reference (``hibench/reference``) never imports this module.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List

import torch

from hibench.reference.dims import Dims


def model_config(dm: Dims):
    """The port's ``ModelConfig`` of a configuration file's L tier."""
    from repro_torch.configs.base import DENSE, MOE, ModelConfig
    kw = dict(name=dm.name, family=MOE if dm.moe else DENSE,
              num_layers=dm.layers, d_model=dm.d, vocab_size=dm.vocab,
              num_heads=dm.heads, num_kv_heads=dm.kv_heads,
              head_dim=dm.head_dim, d_ff=dm.ff, sliding_window=dm.window,
              rope_theta=dm.rope_theta, norm_eps=dm.eps)
    if dm.moe:
        kw.update(num_experts=dm.experts, experts_per_token=dm.top_k,
                  num_shared_experts=dm.shared, d_ff_expert=dm.ff_expert)
    return ModelConfig(**kw)


def check_s_tier(l_cfg, s_dims: Dims, scale: int):
    """The program's S tier (``s_variant``), held to the one the
    benchmark derived for its weights and its reference."""
    s_cfg = l_cfg.s_variant(scale)
    got = (s_cfg.num_layers, s_cfg.d_model, s_cfg.num_heads,
           s_cfg.num_kv_heads, s_cfg.resolved_head_dim, s_cfg.vocab_size,
           s_cfg.num_experts, s_cfg.experts_per_token,
           s_cfg.num_shared_experts, s_cfg.d_ff_expert)
    want = (s_dims.layers, s_dims.d, s_dims.heads, s_dims.kv_heads,
            s_dims.head_dim, s_dims.vocab, s_dims.experts, s_dims.top_k,
            s_dims.shared, s_dims.ff_expert)
    if got != want or (not s_dims.moe and s_cfg.d_ff != s_dims.ff):
        raise RuntimeError(f"the program's S tier {got} is not the "
                           f"benchmark's {want}")
    return s_cfg


def build_engine(l_dims: Dims, s_dims: Dims, serving: dict,
                 max_new_tokens: int, l_params, s_params):
    """The port's engine around the benchmark's weights (theta 0 until
    :func:`set_theta`)."""
    from repro_torch.configs.base import HIConfig
    from repro_torch.serving.engine import HIEngine, TierModel
    l_cfg = model_config(l_dims)
    s_cfg = check_s_tier(l_cfg, s_dims, serving["s_scale"])
    hi = HIConfig(metric=serving["gate_metric"], theta=0.0,
                  s_scale=serving["s_scale"])
    return HIEngine(TierModel(s_cfg, s_params), TierModel(l_cfg, l_params),
                    hi, max_new_tokens=max_new_tokens)


def set_theta(engine, theta: float) -> None:
    import dataclasses
    engine.hi = dataclasses.replace(engine.hi, theta=theta)


def serve_wave(engine, items, first_id: int, serve_kw: dict,
               telemetry=None) -> Dict[int, dict]:
    """Submit one wave at once and serve it to its end."""
    from repro_torch.serving.batcher import Request
    reqs = [Request(request_id=first_id + i, prompt=it.prompt,
                    max_new_tokens=it.max_new_tokens)
            for i, it in enumerate(items)]
    with torch.inference_mode():
        return engine.serve_stream(reqs, telemetry=telemetry, **serve_kw)


def scheduler(engine):
    """The engine's live scheduler (one persists across waves)."""
    return engine._stream[1]


def free_state(engine) -> None:
    """Drop the scheduler, its pools and prefix caches (the weights stay:
    they are the benchmark's)."""
    engine._stream = None
    engine.stats.detach()


def telemetry():
    from repro_torch.serving.telemetry import Telemetry
    return Telemetry()


# kernel entry point -> the kernel's name in the device trace
PAGED_KERNELS = {"decode_attention_paged": "paged_attention_split_kernel",
                 "decode_attention_chunk_paged": "chunk_paged_attention_kernel"}


@contextlib.contextmanager
def tally_kernels(calls: Dict[str, List]):
    """While open, every call of the two paged attention entry points of
    ``repro_torch.kernels.ops`` also records, on the device and without a
    sync, what its inputs need: the valid query-key pairs, the distinct
    valid K/V rows, and the shapes.  ``calls[name]`` gets one
    (pairs, rows, q shape, pool shape, pool itemsize) per call."""
    from repro_torch.kernels import ops
    saved = {name: getattr(ops, name) for name in PAGED_KERNELS}

    def wrap(name, fn):
        def tallied(q, pool_k, pool_v, block, valid, *rest):
            v = valid if valid.ndim == 3 else valid[:, None, :]
            calls.setdefault(name, []).append(
                (v.sum(), v.any(dim=1).sum(), tuple(q.shape),
                 tuple(pool_k.shape), pool_k.element_size()))
            return fn(q, pool_k, pool_v, block, valid, *rest)
        return tallied

    for name, fn in saved.items():
        setattr(ops, name, wrap(name, fn))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)
