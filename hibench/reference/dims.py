"""The sizes of a configuration file, for the reference and the weights.

Reads ``configs/<config>.json`` (the published ``config.json`` keys, as
run) and works out the cascade's S tier from it: the reference derives
both tiers itself and takes nothing from the program under test.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class Dims:
    name: str
    family: str                 # "dense" | "moe"
    layers: int
    d: int
    heads: int
    kv_heads: int
    head_dim: int
    ff: int                     # dense SwiGLU width (dense family)
    vocab: int
    rope_theta: float
    eps: float
    window: int = 0             # 0: full causal attention
    experts: int = 0
    top_k: int = 0
    shared: int = 0             # shared experts, one SwiGLU of shared * ff_expert
    ff_expert: int = 0
    norm_topk: bool = True

    @property
    def moe(self) -> bool:
        return self.family == "moe"


def from_config(cfg: dict) -> Dims:
    """The L tier: the configuration file as run."""
    moe = cfg["family"] == "moe"
    if moe and cfg.get("first_k_dense_replace", 0):
        raise ValueError("leading dense layers are not run by this benchmark")
    return Dims(
        name=cfg["name"], family=cfg["family"],
        layers=cfg["num_hidden_layers"], d=cfg["hidden_size"],
        heads=cfg["num_attention_heads"], kv_heads=cfg["num_key_value_heads"],
        head_dim=cfg.get("head_dim",
                         cfg["hidden_size"] // cfg["num_attention_heads"]),
        ff=cfg["moe_intermediate_size"] if moe else cfg["intermediate_size"],
        vocab=cfg["vocab_size"], rope_theta=float(cfg["rope_theta"]),
        eps=float(cfg["rms_norm_eps"]),
        window=cfg.get("sliding_window") or 0,
        experts=cfg.get("n_routed_experts", 0),
        top_k=cfg.get("num_experts_per_tok", 0),
        shared=cfg.get("n_shared_experts", 0),
        ff_expert=cfg.get("moe_intermediate_size", 0),
        norm_topk=bool(cfg.get("norm_topk_prob", True)))


def s_tier(l: Dims, scale: int) -> Dims:
    """The HI cascade's S tier of ``l`` (arXiv:2304.11763's small model):
    the same family at about 1/scale of the width and depth, heads and
    head size kept so that the attention layout stays the same."""
    heads = max(1, l.heads // scale)
    kv = max(1, min(l.kv_heads, heads))
    while heads % kv:
        kv -= 1
    changes = dict(name=f"{l.name}-s{scale}", layers=max(2, l.layers // scale),
                   d=max(128, l.d // scale), heads=heads, kv_heads=kv,
                   ff=max(128, l.ff // scale))
    if l.moe:
        changes.update(experts=max(4, l.experts // scale),
                       ff_expert=max(64, l.ff_expert // scale))
        changes["ff"] = changes["ff_expert"]
    return dataclasses.replace(l, **changes)


def param_count(dm: Dims) -> dict:
    """Parameters by kind: ``matmul`` are those every token multiplies
    (attention, the dense or the shared and the token's routed experts,
    the router, the LM head), ``total`` all of them."""
    attn = dm.d * dm.head_dim * (2 * dm.heads + 2 * dm.kv_heads)
    if dm.moe:
        expert = 3 * dm.d * dm.ff_expert
        ffn_active = (dm.top_k + dm.shared) * expert + dm.d * dm.experts
        ffn_total = (dm.experts + dm.shared) * expert + dm.d * dm.experts
    else:
        ffn_active = ffn_total = 3 * dm.d * dm.ff
    head = dm.d * dm.vocab
    norms = (2 * dm.layers + 1) * dm.d
    return {"matmul": dm.layers * (attn + ffn_active) + head,
            "total": dm.layers * (attn + ffn_total) + 2 * head + norms}
