"""The plain reference: a decoder-only transformer, dense or MoE, in
float32 PyTorch, one sequence at a time, with no cache, batching or
kernel.

It follows the configuration file as run (``dims.Dims``): pre-norm RMSNorm
blocks, half-split RoPE, grouped-query causal attention (with the sliding
window where the file sets one), a SwiGLU FFN, or, for the MoE family, a
softmax router over the routed experts whose top-k gates are renormalised
where ``norm_topk_prob`` says so, every routed pair computed (no capacity
and no drop), plus the shared experts as one SwiGLU.  The configuration
stores K and V in bfloat16: the reference rounds them to bfloat16 after
RoPE and attends in float32 over the rounded values.

The weights are the tree the benchmark made from the seed
(``hibench/weights.py``), passed in as tensors.  Nothing here imports the
program under test, and matmuls run in float32 with TF32 off unless the
caller asks for TF32 (the control).
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict

import torch
import torch.nn.functional as F

from hibench.reference.dims import Dims


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """float32 matmuls in full float32, or in TF32 where ``tf32``."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-split rotary embedding of x (T, H, Dh) at positions 0..T-1,
    float32 angles."""
    t, _, dh = x.shape
    freqs = 1.0 / theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                         device=x.device) / dh)
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(lp: Dict, dm: Dims, x: torch.Tensor,
              kv_dtype=torch.bfloat16) -> torch.Tensor:
    t = x.shape[0]
    hd, g = dm.head_dim, dm.heads // dm.kv_heads
    q = rope((x @ lp["wq"]).view(t, dm.heads, hd), dm.rope_theta)
    k = rope((x @ lp["wk"]).view(t, dm.kv_heads, hd), dm.rope_theta)
    v = (x @ lp["wv"]).view(t, dm.kv_heads, hd)
    if kv_dtype is not None:          # the configuration's K/V store
        k = k.to(kv_dtype).float()
        v = v.to(kv_dtype).float()
    q = q.view(t, dm.kv_heads, g, hd)
    s = torch.einsum("qkgd,skd->kgqs", q, k) / math.sqrt(hd)
    qpos = torch.arange(t, device=x.device)[:, None]
    kpos = torch.arange(t, device=x.device)[None, :]
    mask = kpos <= qpos
    if dm.window:
        mask &= qpos - kpos < dm.window
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    o = torch.einsum("kgqs,skd->qkgd", p, v).reshape(t, dm.heads * hd)
    return o @ lp["wo"]


def swiglu(w: Dict, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ w["wg"]) * (x @ w["wi"])) @ w["wo"]


def moe(lp: Dict, dm: Dims, x: torch.Tensor) -> torch.Tensor:
    """Every (token, choice) pair of the top-k routed experts, plus the
    shared experts."""
    probs = torch.softmax(x @ lp["router"], dim=-1)
    gate, idx = torch.topk(probs, dm.top_k, dim=-1)
    if dm.norm_topk:
        gate = gate / gate.sum(-1, keepdim=True)
    y = torch.zeros_like(x)
    ex = lp["experts"]
    for e in torch.unique(idx).tolist():
        tok, choice = torch.nonzero(idx == e, as_tuple=True)
        w = {k: ex[k][e] for k in ("wi", "wg", "wo")}
        y.index_add_(0, tok, swiglu(w, x[tok]) * gate[tok, choice, None])
    if dm.shared:
        y = y + swiglu(lp["shared"], x)
    return y


def layer_params(layers: Dict, i: int) -> Dict:
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in layers.items()}


@torch.no_grad()
def logits(params: Dict, dm: Dims, tokens: torch.Tensor, first: int,
           tf32: bool = False, kv_dtype=torch.bfloat16) -> torch.Tensor:
    """Float32 logits (T - first, V) at positions ``first`` .. T-1 of the
    sequence ``tokens`` (T,), run layer by layer over the whole sequence.
    ``kv_dtype`` None keeps K/V in float32."""
    with matmul_precision(tf32):
        h = params["embed"][tokens.long()]
        for i in range(dm.layers):
            lp = layer_params(params["layers"], i)
            h = h + attention(lp["attn"], dm,
                              rmsnorm(h, lp["ln1"]["scale"], dm.eps),
                              kv_dtype)
            xn = rmsnorm(h, lp["ln2"]["scale"], dm.eps)
            h = h + (moe(lp, dm, xn) if dm.moe else swiglu(lp["mlp"], xn))
        h = rmsnorm(h[first:], params["final_norm"]["scale"], dm.eps)
        return h @ params["lm_head"]
