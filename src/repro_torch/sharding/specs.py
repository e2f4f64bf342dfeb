"""Partition rules: param path -> partition spec, the reference's
``sharding/specs.py`` rule for rule, and the executing path's cut.

The rules name, for each dim of a leaf, the mesh axis it is sharded over
(or None).  They read only ``mesh.shape``, a mapping from axis name to
size, so they run on a stand-in mesh of any size (the tests check them at
16 x 16 and 2 x 16 x 16 with no process group).  A dim is sharded only
where the axis size divides it; otherwise the rule degrades to replication
for that dim (``_div``).

Axes:
  data  - batch / FSDP axis
  model - tensor-parallel / expert-parallel axis
  pod   - multi-pod data-parallel axis (batch is sharded over ("pod","data"))

The executing path.  The port's mesh path runs the model code on each
rank's local shards as plain tensors (``sharding/act.py``): a row-parallel
product is followed by an all-reduce over ``model`` and the vocab-sharded
logits by an all-gather.  It follows a rule's ``model`` cut only where it
falls on whole heads (attention), whole ``d_ff`` columns (MLPs), whole
experts or whole vocab columns, and replicates the module otherwise: full
qwen2-1.5b has 2 kv heads, so at ``model = 4`` its ``wk`` columns
(2 x 128) divide but its heads do not; mamba2's mixed ``in_proj`` is
replicated by the rule itself while its ``out_proj`` rows cut across the
mixer's heads.  This is ``_div``'s degrade-to-replicate at head
granularity: the values are the same, only memory differs.
:func:`mesh_report` lists the leaves so replicated, :func:`local_config`
gives the config of one rank's shard and :func:`shard_params` its slices.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, FrozenSet, List, Optional, Tuple

from repro_torch.configs.base import ModelConfig, ShapeConfig

Params = Any


class P(tuple):
    """A partition spec: one entry per dim, an axis name, a tuple of axis
    names, or None (replicated)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _div(dim: int, mesh, axis: Optional[str]) -> Optional[str]:
    """axis if it divides dim, else None (replicate)."""
    if axis is None:
        return None
    if dim % mesh.shape[axis] == 0:
        return axis
    return None


def _trailing_spec(path: Tuple[str, ...], shape: Tuple[int, ...], mesh,
                   fsdp: bool, tp: bool = True) -> P:
    """Spec for the trailing (semantic) dims; leading stack dims -> None.
    ``tp=False`` turns tensor parallelism off for the dense blocks (FSDP
    storage only), the reference's layout for small-d_model MoE models."""
    name = path[-1]
    parents = set(path[:-1])
    d_axis = "data" if fsdp else None
    m_axis = "model" if tp else None

    def spec2(rows: Optional[str], cols: Optional[str]) -> P:
        lead = (None,) * (len(shape) - 2)
        return P(*lead, _div(shape[-2], mesh, rows),
                 _div(shape[-1], mesh, cols))

    def spec1(ax: Optional[str]) -> P:
        lead = (None,) * (len(shape) - 1)
        return P(*lead, _div(shape[-1], mesh, ax))

    # embeddings / head: the embedding table is not vocab-sharded (its
    # D shards over data under FSDP); the lm_head vocab-shards over model
    if name == "embed":
        return spec2(None, d_axis)
    if name == "lm_head":
        return spec2(None, "model")
    if name in ("enc_pos", "dec_pos"):
        return P(*(None,) * len(shape))

    # experts: expert-parallel over model, FF-hidden over data
    if "experts" in parents:
        lead = (None,) * (len(shape) - 3)
        e = shape[-3]
        if name in ("wi", "wg"):        # (E, D, F): F is dim -1
            return P(*lead, _div(e, mesh, "model"), None,
                     _div(shape[-1], mesh, d_axis))
        if name == "wo":                 # (E, F, D): F is dim -2
            return P(*lead, _div(e, mesh, "model"),
                     _div(shape[-2], mesh, d_axis), None)
        return P(*lead, _div(e, mesh, "model"), None, None)
    if name == "router":
        return P(*(None,) * len(shape))

    # attention
    if parents & {"attn", "self_attn", "cross_attn"}:
        if name in ("wq", "wk", "wv"):
            return spec2(d_axis, m_axis)
        if name == "wo":
            return spec2(m_axis, d_axis)
        if name in ("bq", "bk", "bv"):
            return spec1(m_axis)

    # MLPs
    if parents & {"mlp", "shared", "dense"}:
        if name in ("wi", "wg"):
            return spec2(d_axis, m_axis)
        if name == "wo":
            return spec2(m_axis, d_axis)
        if name == "bi":
            return spec1(m_axis)
        if name == "bo":
            return spec1(None)

    # mamba2: the mixed in_proj output crosses z/x/B/C (FSDP rows only);
    # out_proj's rows are head-major
    if name == "in_proj":
        return spec2(d_axis, None)
    if name == "out_proj":
        return spec2("model", d_axis)
    if name in ("conv_w", "conv_b", "A_log", "D", "dt_bias"):
        return P(*(None,) * len(shape))

    # norms / scalars
    return P(*(None,) * len(shape))


def _map_with_path(fn, tree, path: Tuple[str, ...] = ()):
    """``fn(path, leaf)`` over a nested dict, keeping its structure."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def flatten_with_path(tree, path: Tuple[str, ...] = ()
                      ) -> List[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) pairs of a nested dict, in key order."""
    if isinstance(tree, dict):
        return [pl for k, v in tree.items()
                for pl in flatten_with_path(v, path + (k,))]
    return [(path, tree)]


def param_specs(params_tree: Params, mesh, *, fsdp: bool = False,
                tp: bool = True) -> Params:
    """A tree of :class:`P` matching ``params_tree`` (tensors, meta
    tensors or anything with ``.shape``)."""
    return _map_with_path(
        lambda path, leaf: _trailing_spec(path, tuple(leaf.shape), mesh,
                                          fsdp, tp), params_tree)


# ---------------------------------------------------------------------------
# activations / inputs / caches
# ---------------------------------------------------------------------------

def batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def _size(mesh, axes) -> int:
    total = 1
    for a in axes:
        total *= mesh.shape[a]
    return total


def data_spec(mesh, batch: int, ndim: int) -> P:
    """Batch-leading input: shard dim 0 over (pod, data) when divisible."""
    axes = batch_axes(mesh)
    total = _size(mesh, axes)
    lead = axes if (total and batch % total == 0) else None
    return P(lead, *(None,) * (ndim - 1))


def cache_specs(cfg: ModelConfig, mesh, shape: ShapeConfig) -> Params:
    """Specs for the decode cache tree of ``shape``.

    decode_32k: batch over (pod, data), the KV sequence over ``model``
    (sequence-parallel cache).  long_500k (batch 1): the sequence dim
    spreads over every axis that divides it."""
    axes = batch_axes(mesh)
    batch_ok = shape.global_batch % _size(mesh, axes) == 0

    def rule(path, leaf):
        name = path[-1]
        if name == "pos":
            return P()
        nd = len(leaf.shape)
        if name in ("k", "v", "ck", "cv"):
            if nd != 5:
                return P(*(None,) * nd)
            s_dim = leaf.shape[2]
            if batch_ok:
                s_ax = "model" if s_dim % mesh.shape["model"] == 0 else None
                return P(None, axes, s_ax, None, None)
            flat = tuple(a for a in ("data", "model") if a in mesh.shape)
            s_ax2 = flat if s_dim % _size(mesh, flat) == 0 else "data"
            return P(None, None, s_ax2, None, None)
        if name == "state":
            # ssm state (L, B, H, P, N) or (G, k, B, H, P, N)
            lead = (None,) * (nd - 4)
            return P(*lead, axes if batch_ok else None,
                     _div(leaf.shape[-3], mesh, "model"), None, None)
        if name == "conv":
            lead = (None,) * (nd - 3)
            return P(*lead, axes if batch_ok else None, None, None)
        return P(*(None,) * nd)

    return _map_with_path(rule, shape_tree(cfg, shape))


def shape_tree(cfg: ModelConfig, shape: ShapeConfig):
    from repro_torch.models import model_zoo
    return model_zoo.cache_spec(cfg, shape.global_batch, shape.seq_len)


def paged_cache_specs(cfg: ModelConfig, mesh, buffers: Params) -> Params:
    """Specs for a serving tier's paged pool tree (``KVPool.buffers``): the
    L tier's pool shards over ``model`` on the kv-head dim, the cut of the
    attention projections.  ``kp`` / ``vp`` (L, P, page, K, Dh): K over
    model when divisible; ``ks`` / ``vs`` int8 scale rows (L, P, K): K over
    model; everything else (recurrent rows) replicated."""
    del cfg

    def rule(path, leaf):
        name = path[-1]
        nd = len(leaf.shape)
        if name in ("kp", "vp") and nd == 5:
            return P(None, None, None, _div(leaf.shape[3], mesh, "model"),
                     None)
        if name in ("ks", "vs") and nd == 3:
            return P(None, None, _div(leaf.shape[2], mesh, "model"))
        return P(*(None,) * nd)

    return _map_with_path(rule, buffers)


# ---------------------------------------------------------------------------
# the executing path: one rank's shard of the L tier
# ---------------------------------------------------------------------------

# the modules whose row-parallel products (or vocab-sharded logits) the
# model code combines over ``model`` (``act.reduce_model`` /
# ``act.gather_vocab``); "mixer" (mamba2) and "other" are never cut
KINDS = ("attn", "mlp", "shared", "dense", "experts", "lm_head")


def leaf_kind(path: Tuple[str, ...]) -> str:
    """The module a param leaf belongs to, in the rule's order of checks."""
    name, parents = path[-1], set(path[:-1])
    if name == "lm_head":
        return "lm_head"
    if "experts" in parents:
        return "experts"
    if parents & {"attn", "self_attn", "cross_attn"}:
        return "attn"
    for kind in ("mlp", "shared", "dense"):
        if kind in parents:
            return kind
    if name in ("in_proj", "out_proj"):
        return "mixer"
    return "other"


def cut_kinds(cfg: ModelConfig, mesh) -> FrozenSet[str]:
    """The modules the executing path cuts over ``model``: attention where
    the kv heads divide, an MLP where its hidden width does, the routed
    experts where their count does, the lm_head where the vocab does."""
    m = mesh.shape["model"]
    cut = set()
    if cfg.num_kv_heads and cfg.num_kv_heads % m == 0 \
            and cfg.num_heads % m == 0:
        cut.add("attn")
    if cfg.d_ff and cfg.d_ff % m == 0:
        cut.update(("mlp", "dense"))
    if cfg.num_experts and cfg.num_experts % m == 0:
        cut.add("experts")
    if cfg.num_shared_experts and \
            (cfg.num_shared_experts * cfg.d_ff_expert) % m == 0:
        cut.add("shared")
    if cfg.vocab_size % m == 0:
        cut.add("lm_head")
    return frozenset(cut)


def local_config(cfg: ModelConfig, mesh) -> ModelConfig:
    """The config of one rank's shard: heads, kv heads, ``d_ff`` and the
    experts divided by ``model`` where :func:`cut_kinds` cuts them (the
    head dim is pinned, as it would otherwise follow the head count)."""
    m = mesh.shape["model"]
    cut = cut_kinds(cfg, mesh)
    changes: Dict[str, Any] = {"head_dim": cfg.resolved_head_dim}
    if "attn" in cut:
        changes.update(num_heads=cfg.num_heads // m,
                       num_kv_heads=cfg.num_kv_heads // m)
    if "mlp" in cut:
        changes["d_ff"] = cfg.d_ff // m
    if "experts" in cut:
        changes["num_experts"] = cfg.num_experts // m
    return dataclasses.replace(cfg, **changes)


def _plan(params: Params, cfg: ModelConfig, mesh):
    """Per leaf: (path, leaf, spec, cut) with ``cut`` True where the
    executing path slices the rule's ``model`` dims."""
    cut = cut_kinds(cfg, mesh)
    out = []
    for path, leaf in flatten_with_path(params):
        spec = _trailing_spec(path, tuple(leaf.shape), mesh, fsdp=False)
        out.append((path, leaf, spec, leaf_kind(path) in cut))
    return out


def mesh_report(params: Params, cfg: ModelConfig, mesh) -> Dict[str, Any]:
    """Which leaves the executing path cuts over ``model`` and which ones
    the rule would cut but the path keeps whole (``replicated``), as
    "/"-joined paths; reads shapes only, so a ``meta`` tree will do."""
    cut, replicated = [], []
    for path, _, spec, is_cut in _plan(params, cfg, mesh):
        if "model" not in spec:
            continue
        (cut if is_cut else replicated).append("/".join(path))
    return {"model": mesh.shape["model"], "kinds": sorted(cut_kinds(cfg, mesh)),
            "cut": cut, "replicated": replicated}


def shard_params(params: Params, cfg: ModelConfig, mesh) -> Params:
    """This rank's local slices (``mesh.coord("model")``) of every leaf
    the executing path cuts; every other leaf is passed through whole.
    At ``model = 1`` the tree's tensors are returned as they are."""
    m = mesh.shape["model"]
    if m == 1:
        return params
    idx = mesh.coord("model")
    sliced = {}
    for path, leaf, spec, is_cut in _plan(params, cfg, mesh):
        if not is_cut:
            continue
        for dim, ax in enumerate(spec):
            if ax == "model":
                n = leaf.shape[dim] // m
                leaf = leaf.narrow(dim, idx * n, n)
        sliced[path] = leaf.contiguous()
    return _map_with_path(lambda path, leaf: sliced.get(path, leaf), params)
