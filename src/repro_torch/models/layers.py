"""Building blocks of the dense decoder (plain functions on tensors).

Conventions follow the reference's ``models/layers.py``:

* hidden states ``(B, S, D)``; attention heads ``(B, S, H, Dh)``;
* params are nested dicts of tensors; dense weights keep the reference's
  ``(in, out)`` layout and are applied as ``x @ W``;
* masks are boolean, True = attend; masked scores are ``-1e30``.

Only what the dense contiguous-cache path runs is here.  Large matmuls go to
``torch.matmul``; the decode attention goes through ``kernels/ops.py``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

Params = Dict[str, Any]
_NEG = -1e30


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Computed in float32, cast back to x's dtype."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float,
               device: torch.device | str = "cpu") -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Half-split RoPE.  x: (B, S, H, Dh); positions: (S,) int."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = (positions.float()[:, None] * freqs[None, :])[None, :, None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _qkv(params: Params, x: torch.Tensor, num_heads: int, num_kv: int,
         head_dim: int):
    b, s, _ = x.shape
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if "bq" in params:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    return (q.reshape(b, s, num_heads, head_dim),
            k.reshape(b, s, num_kv, head_dim),
            v.reshape(b, s, num_kv, head_dim))


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: Optional[torch.Tensor]) -> torch.Tensor:
    """q: (B,Sq,H,Dh)  k,v: (B,Sk,K,Dh)  GQA via head grouping.

    mask: (B|1, Sq, Sk) bool, True = attend.  As in the reference, q and the
    probabilities are rounded to the cache dtype and the products accumulate
    in float32 (bf16 products are exact in float32, so upcasting the rounded
    operands reproduces ``preferred_element_type=float32``).
    """
    b, sq, h, dh = q.shape
    kheads = k.shape[2]
    groups = h // kheads
    qg = q.reshape(b, sq, kheads, groups, dh).to(k.dtype).float()
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) / math.sqrt(dh)
    if mask is not None:
        scores = torch.where(mask[:, None, None, :, :], scores, _NEG)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype).float(),
                       v.float())
    return out.reshape(b, sq, h, dh).to(q.dtype)


def causal_window_mask(sq: int, sk: int, *, q_offset: int = 0,
                       window: Optional[int] = None,
                       device: torch.device | str = "cpu") -> torch.Tensor:
    """(1, Sq, Sk) boolean mask: causal, optionally sliding-window."""
    qpos = torch.arange(sq, device=device)[:, None] + q_offset
    kpos = torch.arange(sk, device=device)[None, :]
    mask = kpos <= qpos
    if window is not None:
        mask = mask & (qpos - kpos < window)
    return mask[None]


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      q_chunk: int, causal: bool,
                      window: Optional[int] = None) -> torch.Tensor:
    """Query-chunked attention: bounds the score buffer to (B,H,qc,Sk).
    Each query block sees its complete key row, so plain softmax is exact."""
    sq = q.shape[1]
    if sq % q_chunk:
        raise ValueError(f"seq {sq} not divisible by q_chunk {q_chunk}")
    outs = []
    for i in range(sq // q_chunk):
        mask = None
        if causal:
            mask = causal_window_mask(q_chunk, k.shape[1],
                                      q_offset=i * q_chunk, window=window,
                                      device=q.device)
        outs.append(_sdpa(q[:, i * q_chunk:(i + 1) * q_chunk], k, v, mask))
    return torch.cat(outs, dim=1)


def attention_forward(params: Params, x: torch.Tensor, *, num_heads: int,
                      num_kv: int, head_dim: int, rope_theta: float,
                      causal: bool = True, window: Optional[int] = None,
                      q_chunk: int = 512) -> torch.Tensor:
    """Full-sequence self-attention (the forward pass; K/V not rounded)."""
    b, s, _ = x.shape
    q, k, v = _qkv(params, x, num_heads, num_kv, head_dim)
    if rope_theta > 0:
        pos = torch.arange(s, device=x.device)
        q = apply_rope(q, pos, rope_theta)
        k = apply_rope(k, pos, rope_theta)
    if s > q_chunk and s % q_chunk == 0:
        out = chunked_attention(q, k, v, q_chunk=q_chunk, causal=causal,
                                window=window)
    else:
        mask = (causal_window_mask(s, s, window=window, device=x.device)
                if causal else None)
        out = _sdpa(q, k, v, mask)
    return out.reshape(b, s, num_heads * head_dim) @ params["wo"]


def decode_valid(seq: int, pos: int, window: Optional[int],
                 device: torch.device | str) -> torch.Tensor:
    """(S,) bool validity of the cache rows for a query at ``pos``."""
    kpos = torch.arange(seq, device=device)
    valid = kpos <= pos
    if window is not None:
        valid = valid & (pos - kpos < window)
    return valid


def attention_decode(params: Params, x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos: int, *, num_heads: int,
                     num_kv: int, head_dim: int, rope_theta: float,
                     window: Optional[int] = None) -> torch.Tensor:
    """One-token decode.  x: (B, 1, D); cache_k/v: (B, S, K, Dh) views of
    one layer; pos: the host-side position (every row decodes at the same
    depth in the drained batch, so it is a python int, not a device value).

    Writes the new K/V into row ``pos`` of the caches IN PLACE (the
    reference's ``dynamic_update_slice``) and returns out (B, 1, D)."""
    b = x.shape[0]
    q, k, v = _qkv(params, x, num_heads, num_kv, head_dim)
    if rope_theta > 0:
        p1 = torch.full((1,), pos, dtype=torch.int64, device=x.device)
        q = apply_rope(q, p1, rope_theta)
        k = apply_rope(k, p1, rope_theta)
    cache_k[:, pos] = k[:, 0].to(cache_k.dtype)
    cache_v[:, pos] = v[:, 0].to(cache_v.dtype)
    valid = decode_valid(cache_k.shape[1], pos, window, x.device)
    out = ops.decode_attention(q, cache_k, cache_v, valid)
    return out.reshape(b, 1, num_heads * head_dim) @ params["wo"]


def swiglu(params: Params, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ params["wg"]) * (x @ params["wi"])) @ params["wo"]
