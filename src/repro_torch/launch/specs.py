"""Meta-tensor inputs and partition specs for every (architecture x input
shape x mesh) dry-run case: the reference's ``launch/specs.py`` on the
port's executing path.  Nothing is allocated.

Each builder returns ``(fn, args, in_specs, out_specs)``:

* ``fn`` is the port's own code path as ONE rank runs it on its local
  shards (``sharding/specs.local_config`` / ``shard_params``, the ambient
  ``model`` sub-mesh through ``sharding/act.use_mesh``, and
  ``training/trainer.make_train_step(..., mesh=)``); its ``plan``
  attribute says which plan ran;
* ``args`` are meta tensors of this rank's inputs;
* the specs are the reference's partition rules (``sharding/specs.py``,
  leaf for leaf the reference's), trees of ``P``.

Where the executing path has no counterpart of a reference layout (FSDP
storage, ZeRO's per-layer gathers, ``tp=False``, the sequence-parallel
cache), the case runs the port's own plan and ``fn.plan`` names it:

* serving (prefill, decode, split-cache decode; the L tier of the HI
  case): the batch's rows over (pod, data) where they divide, tensor
  parallel over ``model`` where ``cut_kinds`` cuts (heads, ``d_ff``,
  experts, vocab), every other module and the cache's sequence whole on
  the rank; the enc-dec family has no mesh path and runs whole;
* the HI case's S tier: one whole replica per rank over its rows;
* training: data parallel over ``data`` (each rank's ``data_spec``
  rows, grads and metrics averaged by one all-reduce); params, grads and
  moments whole on every rank, ``pod`` and ``model`` replicated.

Decode cases decode at position ``seq_len - 1``: the step that reads the
whole cache.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.base import (ENCDEC, VLM, ModelConfig, ShapeConfig,
                                      TrainConfig)
from repro_torch.core import router as router_mod
from repro_torch.core.confidence import confidence
from repro_torch.models import model_zoo, transformer
from repro_torch.optim import adamw
from repro_torch.sharding import act
from repro_torch.sharding import specs as sh
from repro_torch.sharding.specs import P
from repro_torch.tree import tree_map

I32 = torch.int32
BF16 = torch.bfloat16


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def text_len(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """VLM: the sequence budget is patches + text."""
    if cfg.family == VLM and shape.mode != "decode":
        return shape.seq_len - cfg.num_patches
    return shape.seq_len


def batch_specs(cfg: ModelConfig, shape: ShapeConfig,
                batch: Optional[int] = None) -> Dict[str, Any]:
    """Model inputs as meta tensors of ``batch`` rows (default: the
    shape's global batch)."""
    b = shape.global_batch if batch is None else batch
    tl = text_len(cfg, shape)
    if shape.mode == "decode":
        return {"token": _meta((b, 1), I32)}
    out: Dict[str, Any] = {"tokens": _meta((b, tl), I32)}
    if shape.mode == "train":
        out["labels"] = _meta((b, tl), I32)
    if cfg.family == ENCDEC:
        out["frames"] = _meta((b, cfg.num_audio_frames, cfg.d_model), BF16)
    if cfg.family == VLM:
        out["patches"] = _meta((b, cfg.num_patches, cfg.d_model), BF16)
    return out


def batch_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh) -> Any:
    return tree_map(lambda s: sh.data_spec(mesh, s.shape[0], s.ndim),
                    batch_specs(cfg, shape))


def grad_accum_for(cfg: ModelConfig, shape: ShapeConfig, mesh) -> int:
    """Microbatch accumulation: keeps saved residuals bounded.  The
    microbatch size must stay divisible by the batch-sharding axes."""
    if shape.mode != "train":
        return 1
    batch_shards = _nbatch(mesh)
    # rough param count proxy: d_model^2 * layers (+ experts)
    accum = 16 if cfg.d_model >= 7000 else 8
    while shape.global_batch // accum < batch_shards and accum > 1:
        accum //= 2
    return accum


def _all_axes_spec(mesh, batch: int, ndim: int) -> P:
    """ZeRO-DP: shard the batch over EVERY mesh axis when it divides."""
    axes = tuple(a for a in ("pod", "data", "model") if a in mesh.shape)
    if batch % math.prod(mesh.shape[a] for a in axes) == 0:
        return P(axes, *(None,) * (ndim - 1))
    return sh.data_spec(mesh, batch, ndim)


def _nbatch(mesh) -> int:
    return math.prod(mesh.shape[a] for a in sh.batch_axes(mesh))


def _local_rows(mesh, batch: int) -> int:
    """This rank's rows of a batch sharded over (pod, data), or all of
    them where the axes do not divide it."""
    n = _nbatch(mesh)
    return batch // n if batch % n == 0 else batch


def serving_fsdp(cfg: ModelConfig, mesh, threshold_gb: float = 8.0) -> bool:
    """Serving wants TP-only weights (no per-step FSDP all-gathers) unless
    the TP-sharded weights alone would blow the HBM budget (arctic-480b):
    the reference's rule, at 2 bytes a parameter."""
    params = model_zoo.init_params_spec(cfg, BF16)
    total = sum(2 * leaf.numel() for _, leaf in sh.flatten_with_path(params))
    return total / mesh.shape["model"] > threshold_gb * 1e9


def _case(fn: Callable, plan: str) -> Callable:
    """``fn`` with the plan it runs as its ``plan`` attribute."""
    fn.plan = plan
    return fn


class _TP:
    """One rank's tensor-parallel shard of ``cfg`` on the ``model``
    sub-mesh: its config, cut, params and a ``run`` context."""

    def __init__(self, cfg: ModelConfig, mesh, dtype):
        params = model_zoo.init_params_spec(cfg, dtype)
        if cfg.family == ENCDEC:        # no mesh path: whole on the rank
            self.cut, self.cfg, self.params = frozenset(), cfg, params
        else:
            self.cut = sh.cut_kinds(cfg, mesh)
            self.cfg = sh.local_config(cfg, mesh)
            self.params = sh.shard_params(params, cfg, mesh)
        self.mesh = mesh.sub("model")

    def run(self):
        return act.use_mesh(self.mesh, self.cut)

    def plan(self, rows: int, batch: int) -> str:
        cut = ", ".join(sorted(self.cut)) or "nothing"
        return (f"tp over model={self.mesh.shape['model']} cuts {cut}; "
                f"{rows} of {batch} rows a rank")


def _decode_cache(cfg: ModelConfig, batch: int, seq_len: int, split=False):
    cache = (transformer.split_cache_spec(cfg, batch, seq_len) if split
             else model_zoo.cache_spec(cfg, batch, seq_len))
    cache["pos"] = seq_len - 1
    return cache


def make_train_case(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
                    fsdp: bool = True, variant: str = "baseline"):
    """The reference's variants: ``zero_dp`` / ``ep_dp`` (and their
    ``*_lean``) take no microbatch accumulation; the ``lean`` ones a
    factored second moment and bf16 accumulation.  Their layouts (ZeRO's
    batch over every axis, expert-parallel-only compute) are the specs';
    the port's step runs its data-parallel plan under each."""
    from repro_torch.training import trainer

    zero = variant in ("zero_dp", "zero_lean")
    epdp = variant in ("ep_dp", "ep_lean")
    lean = variant in ("lean_opt", "zero_lean", "ep_lean")
    tcfg = TrainConfig(
        grad_accum=1 if (zero or epdp) else grad_accum_for(cfg, shape, mesh),
        bf16_state=True, remat=True,
        factored_v=lean, accum_dtype="bfloat16" if lean else "float32")
    params = model_zoo.init_params_spec(cfg, BF16)
    opt = adamw.init_state(params, tcfg)
    batch = batch_specs(cfg, shape)

    p_sh = sh.param_specs(params, mesh, fsdp=fsdp, tp=not epdp)
    factored = lambda v: isinstance(v, dict) and set(v) == {"vr", "vc"}
    v_sh = tree_map(lambda v, p: {"vr": P(), "vc": P()} if factored(v) else p,
                    opt["v"], p_sh, is_leaf=factored)
    o_sh = {"m": p_sh, "v": v_sh, "step": P()}
    if zero:
        b_sh = tree_map(lambda s: _all_axes_spec(mesh, s.shape[0], s.ndim),
                        batch)
    else:
        b_sh = batch_shardings(cfg, shape, mesh)
    metrics = {k: P() for k in ("loss", "nll", "aux", "lr", "grad_norm")}

    step = trainer.make_train_step(cfg, tcfg, mesh=mesh)
    plan = (f"dp over data={mesh.shape['data']} ({variant}: grad_accum "
            f"{tcfg.grad_accum}); params, grads and moments whole on "
            f"every rank")
    return (_case(step, plan), (params, opt, batch), (p_sh, o_sh, b_sh),
            (p_sh, o_sh, metrics))


def make_prefill_case(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
                      fsdp: Optional[bool] = None):
    """Prefill runs the full forward over the prompt; only the last
    position's logits are projected (``forward(..., last_only=True)``)."""
    if fsdp is None:
        fsdp = serving_fsdp(cfg, mesh)
    tp = _TP(cfg, mesh, BF16)
    b = shape.global_batch
    rows = _local_rows(mesh, b)
    batch = batch_specs(cfg, shape, rows)
    p_sh = sh.param_specs(model_zoo.init_params_spec(cfg, BF16), mesh,
                          fsdp=fsdp)
    b_sh = batch_shardings(cfg, shape, mesh)
    batch_ok = b % _nbatch(mesh) == 0
    logits_sh = P(sh.batch_axes(mesh) if batch_ok else None, None, None)

    def fn(params, batch):
        with tp.run():
            return model_zoo.forward(params, tp.cfg, batch["tokens"],
                                     patches=batch.get("patches"),
                                     frames=batch.get("frames"),
                                     last_only=True)

    return (_case(fn, tp.plan(rows, b)), (tp.params, batch), (p_sh, b_sh),
            logits_sh)


def make_decode_case(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
                     fsdp: Optional[bool] = None):
    """serve_step: ONE new token against a seq_len KV cache."""
    if fsdp is None:
        fsdp = serving_fsdp(cfg, mesh)
    tp = _TP(cfg, mesh, BF16)
    b = shape.global_batch
    rows = _local_rows(mesh, b)
    cache = _decode_cache(tp.cfg, rows, shape.seq_len)
    token = _meta((rows, 1), I32)

    p_sh = sh.param_specs(model_zoo.init_params_spec(cfg, BF16), mesh,
                          fsdp=fsdp)
    c_sh = sh.cache_specs(cfg, mesh, shape)
    baxes = sh.batch_axes(mesh) if b % _nbatch(mesh) == 0 else None
    t_sh = P(baxes, None)

    def fn(params, token, cache):
        with tp.run():
            return model_zoo.decode_step(params, tp.cfg, token, cache)

    return (_case(fn, tp.plan(rows, b)), (tp.params, token, cache),
            (p_sh, t_sh, c_sh), (P(baxes, None), c_sh))


def split_cache_specs(cfg: ModelConfig, mesh, shape: ShapeConfig) -> Any:
    """The reference's specs of the split cache: rings batch-sharded,
    global stacks sequence-parallel as the uniform cache."""
    b = shape.global_batch
    batch_ok = b % _nbatch(mesh) == 0
    baxes = sh.batch_axes(mesh) if batch_ok else None

    def rule(name, leaf):
        if name == "pos":
            return P()
        if name.startswith("local"):        # (n_local, B, W, K, Dh)
            return P(None, baxes, None, None, None)
        s_dim = leaf.shape[2]
        if batch_ok:
            s_ax = "model" if s_dim % mesh.shape["model"] == 0 else None
            return P(None, baxes, s_ax, None, None)
        flat = tuple(a for a in ("data", "model") if a in mesh.shape)
        tot = math.prod(mesh.shape[a] for a in flat)
        return P(None, None, flat if s_dim % tot == 0 else "data", None,
                 None)

    spec = transformer.split_cache_spec(cfg, b, shape.seq_len)
    return {k: rule(k, v) for k, v in spec.items()}


def make_split_decode_case(cfg: ModelConfig, shape: ShapeConfig, mesh):
    """serve_step over ring-buffered local caches (sliding-window archs):
    local layers keep only W positions, so both the resident cache and
    each step's cache reads drop by ~S/W on the local layers."""
    if not cfg.sliding_window:
        raise ValueError("split cache needs a sliding-window arch")
    tp = _TP(cfg, mesh, BF16)
    b = shape.global_batch
    rows = _local_rows(mesh, b)
    cache = _decode_cache(tp.cfg, rows, shape.seq_len, split=True)
    token = _meta((rows, 1), I32)

    p_sh = sh.param_specs(model_zoo.init_params_spec(cfg, BF16), mesh,
                          fsdp=serving_fsdp(cfg, mesh))
    c_sh = split_cache_specs(cfg, mesh, shape)
    baxes = sh.batch_axes(mesh) if b % _nbatch(mesh) == 0 else None
    t_sh = P(baxes, None)

    def fn(params, token, cache):
        with tp.run():
            return transformer.decode_step_split(params, tp.cfg, token, cache)

    return (_case(fn, tp.plan(rows, b)), (tp.params, token, cache),
            (p_sh, t_sh, c_sh), (P(baxes, None), c_sh))


def make_hi_decode_case(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
                        capacity_factor: float = 0.5, theta: float = 0.607,
                        s_scale: int = 4, dtype=BF16):
    """The paper's technique as ONE step: the HI cascade's serve_step.

    The S tier (``cfg.s_variant``) decodes every request; the confidence
    (``max_prob``, the oracle ``confidence``) and the static-capacity
    router escalate the least confident (capacity = capacity_factor x
    batch) to the L tier (the full config), whose KV cache covers exactly
    ``capacity`` streams.  On a mesh each (pod, data) rank routes its own
    rows with its share of the capacity; the S tier is one whole replica
    a rank, the L tier tensor parallel over ``model``.  ``dtype``: the
    params' (the reference's bf16; the card runs the port's float32)."""
    s_cfg = cfg.s_variant(s_scale)
    b = shape.global_batch
    cap = router_mod.capacity_for(b, capacity_factor)
    # keep the complex sub-batch shardable over the batch axes
    nb = _nbatch(mesh)
    if b % nb == 0 and cap % nb:
        cap = max(nb, (cap // nb) * nb)
    rows = _local_rows(mesh, b)
    cap_rows = cap // (b // rows)

    s_params = model_zoo.init_params_spec(s_cfg, dtype)
    tp = _TP(cfg, mesh, dtype)
    s_cache = _decode_cache(s_cfg, rows, shape.seq_len)
    l_cache = _decode_cache(tp.cfg, cap_rows, shape.seq_len)
    token = _meta((rows, 1), I32)

    sp_sh = sh.param_specs(s_params, mesh, fsdp=False)
    lp_sh = sh.param_specs(model_zoo.init_params_spec(cfg, dtype), mesh,
                           fsdp=serving_fsdp(cfg, mesh))
    sc_sh = sh.cache_specs(s_cfg, mesh, shape)
    lc_sh = sh.cache_specs(cfg, mesh,
                           dataclasses.replace(shape, global_batch=cap))
    baxes = sh.batch_axes(mesh) if b % _nbatch(mesh) == 0 else None

    def hi_serve_step(s_params, l_params, token, s_cache, l_cache):
        s_logits, s_cache = model_zoo.decode_step(s_params, s_cfg, token,
                                                  s_cache)
        conf = confidence(s_logits, "max_prob")
        decision = router_mod.route(conf < theta, conf, cap_rows)
        # the ED->ES link: gather the complex sub-batch
        l_token = token[decision.indices]
        with tp.run():
            l_logits, l_cache = model_zoo.decode_step(l_params, tp.cfg,
                                                      l_token, l_cache)
        merged = router_mod.scatter_merge(s_logits, l_logits, decision)
        return merged, s_cache, l_cache, decision.served_remote

    plan = (f"S tier whole, {rows} of {b} rows a rank; L tier "
            f"{tp.plan(cap_rows, cap)}")
    args = (s_params, tp.params, token, s_cache, l_cache)
    in_sh = (sp_sh, lp_sh, P(baxes, None), sc_sh, lc_sh)
    out_sh = (P(baxes, None), sc_sh, lc_sh, P(baxes))
    return _case(hi_serve_step, plan), args, in_sh, out_sh


def make_case(cfg: ModelConfig, shape: ShapeConfig, mesh,
              variant: str = "baseline"):
    if shape.mode == "train":
        return make_train_case(cfg, shape, mesh, fsdp=True, variant=variant)
    if shape.mode == "prefill":
        return make_prefill_case(cfg, shape, mesh)
    if variant == "split_cache":
        return make_split_decode_case(cfg, shape, mesh)
    return make_decode_case(cfg, shape, mesh)


def donate_for(shape: ShapeConfig) -> tuple:
    """The arguments ``fn`` updates in place: a train step its params and
    optimizer state, a decode step its cache (the reference donates the
    same ones).  The HI case updates both caches, (3, 4)."""
    if shape.mode == "train":
        return (0, 1)
    if shape.mode == "decode":
        return (2,)
    return ()
