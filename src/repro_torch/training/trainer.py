"""Training step: loss -> grads -> AdamW, with microbatch gradient
accumulation (the reference's ``training/trainer.py``; its ``lax.scan``
over microbatches is a loop here, summing into an ``accum_dtype``
buffer).

The params are the port's dict trees of plain tensors.  Gradients are taken
with ``torch.autograd.grad`` with respect to detached views of them (no
copy, and nothing set on the caller's tensors), so a tree that serving
holds under ``inference_mode`` stays as it is until the optimizer writes
it.  On the card the forward reaches the kernels the families use
(``ssd_chunk`` for the SSM and hybrid families, under autograd).

Data parallelism (``make_train_step(..., mesh=)``, a ``launch/mesh.Mesh``
with a ``data`` axis): each rank takes its ``sharding/specs.data_spec``
slice of the batch, and the grads and metrics are averaged by one
all-reduce over ``data`` before clipping and AdamW, so every rank applies
the same update.  Params stay whole on every rank: the reference's FSDP
storage is a layout its own meshed step cannot run on jax 0.9.0, and the
step is held against the unmeshed one on the whole batch instead.
"""
from __future__ import annotations

from functools import partial
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.models import model_zoo
from repro_torch.optim import adamw
from repro_torch.sharding import specs
from repro_torch.tree import leaves, tree_map, unflatten

Params = Any
Batch = Dict[str, torch.Tensor]


def _split_microbatches(batch: Batch, n: int) -> list:
    """(B, ...) -> n batches of (B // n, ...)."""
    for k, x in batch.items():
        if x.shape[0] % n:
            raise ValueError(f"batch {x.shape[0]} ({k}) not divisible by "
                             f"grad_accum {n}")
    return [{k: x.reshape(n, x.shape[0] // n, *x.shape[1:])[i]
             for k, x in batch.items()} for i in range(n)]


def _value_and_grad(params: Params, mcfg: ModelConfig, tcfg: TrainConfig,
                    batch: Batch):
    flat = leaves(params)
    wrt = [p.detach().requires_grad_(p.is_floating_point()) for p in flat]
    with torch.enable_grad():
        loss, metrics = model_zoo.loss(unflatten(params, wrt), mcfg, batch,
                                       remat=tcfg.remat)
        got = iter(torch.autograd.grad(
            loss, [p for p in wrt if p.requires_grad], allow_unused=True))
    grads = []
    for p in wrt:
        g = next(got) if p.requires_grad else None
        grads.append(torch.zeros_like(p) if g is None else g)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            unflatten(params, grads))


def grads_and_metrics(params: Params, mcfg: ModelConfig, tcfg: TrainConfig,
                      batch: Batch) -> Tuple[Params, Dict[str, torch.Tensor]]:
    if tcfg.grad_accum <= 1:
        loss, metrics, grads = _value_and_grad(params, mcfg, tcfg, batch)
        return grads, dict(metrics, loss=loss)

    acc_dt = getattr(torch, tcfg.accum_dtype)
    acc = tree_map(lambda p: torch.zeros(p.shape, dtype=acc_dt,
                                         device=p.device), params)
    per = []
    loss = None
    for mb in _split_microbatches(batch, tcfg.grad_accum):
        loss, metrics, grads = _value_and_grad(params, mcfg, tcfg, mb)
        tree_map(lambda a, g: a.add_(g.to(acc_dt)), acc, grads)
        per.append(metrics)
    grads = tree_map(lambda g: (g.to(torch.float32) / tcfg.grad_accum
                                ).to(acc_dt), acc)
    metrics = {k: torch.mean(torch.stack([m[k] for m in per]))
               for k in per[0]}
    return grads, dict(metrics, loss=loss)


def local_batch(batch: Batch, mesh) -> Batch:
    """This rank's ``data_spec`` slice of a batch-leading batch (all of it
    where the ``data`` size does not divide the batch)."""
    n = mesh.shape["data"]
    out = {}
    for k, x in batch.items():
        if specs.data_spec(mesh, x.shape[0], x.ndim)[0] is None:
            out[k] = x
            continue
        rows = x.shape[0] // n
        out[k] = x[mesh.coord("data") * rows:(mesh.coord("data") + 1) * rows]
    return out


def mean_over_data(grads: Params, metrics: Dict[str, torch.Tensor], mesh):
    """Grads and metrics averaged over ``data``: one all-reduce of a flat
    buffer per dtype."""
    import torch.distributed as dist
    n = mesh.shape["data"]
    flat = leaves(grads) + [metrics[k] for k in sorted(metrics)]
    out: list = [None] * len(flat)
    for dt in sorted({t.dtype for t in flat}, key=str):
        idx = [i for i, t in enumerate(flat) if t.dtype == dt]
        buf = torch.cat([flat[i].reshape(-1) for i in idx])
        dist.all_reduce(buf, group=mesh.group("data"))
        buf = buf / n
        at = 0
        for i in idx:
            out[i] = buf[at:at + flat[i].numel()].view(flat[i].shape)
            at += flat[i].numel()
    ng = len(leaves(grads))
    return (unflatten(grads, out[:ng]),
            dict(zip(sorted(metrics), out[ng:])))


def train_step(params: Params, opt_state: Dict[str, Any], batch: Batch, *,
               mcfg: ModelConfig, tcfg: TrainConfig, mesh=None
               ) -> Tuple[Params, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One step; the optimizer writes params and state in place
    (``adamw.apply_updates``) and returns them.  On a mesh, data
    parallel: this rank's slice of ``batch``, grads averaged over
    ``data``."""
    if mesh is not None:
        batch = local_batch(batch, mesh)
    grads, metrics = grads_and_metrics(params, mcfg, tcfg, batch)
    if mesh is not None:
        grads, metrics = mean_over_data(grads, metrics, mesh)
    params, opt_state, opt_metrics = adamw.apply_updates(params, grads,
                                                         opt_state, tcfg)
    return params, opt_state, {**metrics, **opt_metrics}


def make_train_step(mcfg: ModelConfig, tcfg: TrainConfig, mesh=None):
    return partial(train_step, mcfg=mcfg, tcfg=tcfg, mesh=mesh)


@torch.no_grad()
def eval_step(params: Params, batch: Batch, *, mcfg: ModelConfig
              ) -> Dict[str, torch.Tensor]:
    logits = model_zoo.forward(params, mcfg, batch["tokens"],
                               patches=batch.get("patches"),
                               frames=batch.get("frames"))
    if mcfg.family == "vlm":
        logits = logits[:, -batch["labels"].shape[1]:, :]
    nll = model_zoo.cross_entropy(logits, batch["labels"])
    pred = torch.argmax(logits, dim=-1)
    acc = torch.mean((pred == batch["labels"]).to(torch.float32))
    return {"nll": nll, "acc": acc}
