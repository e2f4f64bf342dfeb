"""Dense decoder-only transformer (qwen2 / gemma3) on a contiguous KV cache.

The reference scans one layer body over ``(L, ...)``-stacked params; here a
python loop walks the same stacked params layer by layer.  Per-layer
heterogeneity (gemma3's 5:1 local:global attention) is a per-layer window
size, as in the reference.

The cache dict holds ``k``/``v`` of shape (L, B, S, K, Dh) and ``pos``, the
number of filled rows, kept as a python int: in the drained batch every row
decodes at the same depth, so the position is known on the host and no
device value is ever read back to pick the write row.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _normal(gen: torch.Generator, shape, std: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device) * std


def _dense(gen, shape) -> torch.Tensor:
    """A stacked (..., in, out) weight with the reference's 1/sqrt(in) scale."""
    return _normal(gen, shape, 1.0 / math.sqrt(shape[-2]))


def init_decoder(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Random float32 params with the reference's shapes, layout and
    scales, on the generator's device.  (The numbers differ from the
    reference's: torch's generator is not jax's.  Parity tests bridge the
    reference's params.)"""
    n, d, hd = cfg.num_layers, cfg.d_model, cfg.resolved_head_dim
    hq, hk, ff = cfg.num_heads * hd, cfg.num_kv_heads * hd, cfg.d_ff
    dev = gen.device

    def ones(*shape):
        return torch.ones(shape, device=dev)

    def zeros(*shape):
        return torch.zeros(shape, device=dev)

    attn = {"wq": _dense(gen, (n, d, hq)),
            "wk": _dense(gen, (n, d, hk)),
            "wv": _dense(gen, (n, d, hk)),
            "wo": _dense(gen, (n, hq, d))}
    if cfg.qkv_bias:
        attn.update(bq=zeros(n, hq), bk=zeros(n, hk), bv=zeros(n, hk))
    layers = {"ln1": {"scale": ones(n, d)}, "attn": attn,
              "ln2": {"scale": ones(n, d)},
              "mlp": {"wi": _dense(gen, (n, d, ff)),
                      "wg": _dense(gen, (n, d, ff)),
                      "wo": _dense(gen, (n, ff, d))}}
    return {"embed": _normal(gen, (cfg.vocab_size, d), 0.02),
            "layers": layers,
            "final_norm": {"scale": ones(d)},
            "lm_head": _dense(gen, (d, cfg.vocab_size))}


def layer_params(layers: Params, i: int) -> Params:
    """Layer ``i`` of the stacked layer params (views, no copy)."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in layers.items()}


def layer_windows(cfg: ModelConfig, seq_len: int) -> List[int]:
    """Per-layer sliding-window sizes; ``seq_len`` means full causal."""
    if cfg.local_global_ratio:
        period = cfg.local_global_ratio + 1
        return [seq_len if i % period == cfg.local_global_ratio
                else cfg.sliding_window for i in range(cfg.num_layers)]
    if cfg.sliding_window:
        return [cfg.sliding_window] * cfg.num_layers
    return [seq_len] * cfg.num_layers


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def forward(params: Params, cfg: ModelConfig,
            tokens: torch.Tensor) -> torch.Tensor:
    """tokens: (B, S) -> logits (B, S, V) float32."""
    h = params["embed"][tokens]
    windows = layer_windows(cfg, tokens.shape[1])
    for i, win in enumerate(windows):
        lp = layer_params(params["layers"], i)
        h = h + L.attention_forward(
            lp["attn"], L.rmsnorm(lp["ln1"], h, cfg.norm_eps),
            num_heads=cfg.num_heads, num_kv=cfg.num_kv_heads,
            head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
            window=win)
        h = h + L.swiglu(lp["mlp"], L.rmsnorm(lp["ln2"], h, cfg.norm_eps))
    h = L.rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return (h @ params["lm_head"]).float()


# ---------------------------------------------------------------------------
# contiguous KV cache: prefill + decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               dtype=torch.bfloat16, device="cuda") -> Params:
    shape = (cfg.num_layers, batch, seq_len, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": 0}


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            cache: Params) -> Tuple[torch.Tensor, Params]:
    """Fill the KV cache from a (B, S) prompt in one batched pass.

    K/V are rounded to the cache dtype *before* the in-pass attention, so
    logits and cache match the token-by-token decode path.  Sequences longer
    than 512 that divide into 512-query chunks take the chunked attention.
    The prompt's K/V are written into rows [0, S) of ``cache`` IN PLACE (the
    reference's ``dynamic_update_slice``); rows past S are never read.

    Returns (logits of the last position (B, V) float32, cache).  The last
    position is ``S - 1`` for every row, right padding included: that is
    the reference's semantics.
    """
    h = params["embed"][tokens]
    b, s, _ = h.shape
    kv_dtype = cache["k"].dtype
    hd = cfg.resolved_head_dim
    pos = torch.arange(s, device=h.device)
    for i, win in enumerate(layer_windows(cfg, s)):
        lp = layer_params(params["layers"], i)
        q, k, v = L._qkv(lp["attn"], L.rmsnorm(lp["ln1"], h, cfg.norm_eps),
                         cfg.num_heads, cfg.num_kv_heads, hd)
        if cfg.rope_theta > 0:
            q = L.apply_rope(q, pos, cfg.rope_theta)
            k = L.apply_rope(k, pos, cfg.rope_theta)
        k, v = k.to(kv_dtype), v.to(kv_dtype)
        if s > 512 and s % 512 == 0:
            a = L.chunked_attention(q, k, v, q_chunk=512, causal=True,
                                    window=win)
        else:
            a = L._sdpa(q, k, v, L.causal_window_mask(s, s, window=win,
                                                      device=h.device))
        h = h + a.reshape(b, s, cfg.num_heads * hd) @ lp["attn"]["wo"]
        h = h + L.swiglu(lp["mlp"], L.rmsnorm(lp["ln2"], h, cfg.norm_eps))
        cache["k"][i, :, :s] = k
        cache["v"][i, :, :s] = v
    h = L.rmsnorm(params["final_norm"], h, cfg.norm_eps)
    logits = (h[:, -1, :] @ params["lm_head"]).float()
    return logits, {"k": cache["k"], "v": cache["v"], "pos": s}


def decode_step(params: Params, cfg: ModelConfig, token: torch.Tensor,
                cache: Params) -> Tuple[torch.Tensor, Params]:
    """token: (B, 1) -> (logits (B, V) float32, cache advanced by one row).
    The new K/V rows are written into ``cache`` in place."""
    h = params["embed"][token]
    pos = cache["pos"]
    seq = cache["k"].shape[2]
    for i, win in enumerate(layer_windows(cfg, seq)):
        lp = layer_params(params["layers"], i)
        h = h + L.attention_decode(
            lp["attn"], L.rmsnorm(lp["ln1"], h, cfg.norm_eps),
            cache["k"][i], cache["v"][i], pos, num_heads=cfg.num_heads,
            num_kv=cfg.num_kv_heads, head_dim=cfg.resolved_head_dim,
            rope_theta=cfg.rope_theta, window=win)
        h = h + L.swiglu(lp["mlp"], L.rmsnorm(lp["ln2"], h, cfg.norm_eps))
    h = L.rmsnorm(params["final_norm"], h, cfg.norm_eps)
    logits = (h[:, 0, :] @ params["lm_head"]).float()
    return logits, {"k": cache["k"], "v": cache["v"], "pos": pos + 1}
