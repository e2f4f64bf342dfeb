"""Whisper-style encoder-decoder backbone [arXiv:2212.04356], a copy of the
reference's ``models/whisper.py``.

The mel-spectrogram and conv feature extractor are a stub, as in the
reference: the model consumes precomputed frame embeddings ``frames (B,
num_audio_frames, d_model)``.  Pre-LN blocks with LayerNorm and a GELU MLP,
learned positional embeddings, no RoPE.  Decoding keeps a self-attention
KV cache and per-layer cross-attention K/V computed once from the encoder
states (:func:`precompute_cross`).  The family has no paged API and is not
served, as in the reference.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.transformer import (_dense, _normal,
                                            attention_params, layer_params,
                                            maybe_remat)

Params = Dict[str, Any]

MAX_SEQ = 32_768        # rows of the learned decoder position table


def _layernorm_params(n, d, dev):
    return {"scale": torch.ones(n, d, device=dev),
            "bias": torch.zeros(n, d, device=dev)}


def _gelu_mlp_params(gen, n, d, ff):
    dev = gen.device
    return {"wi": _dense(gen, (n, d, ff)), "wo": _dense(gen, (n, ff, d)),
            "bi": torch.zeros(n, ff, device=dev),
            "bo": torch.zeros(n, d, device=dev)}


def init_model(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Random float32 params in the reference's layout, ``dec_pos`` a
    learned table of ``MAX_SEQ`` rows as the reference's default, so that
    bridged trees match."""
    d, dev = cfg.d_model, gen.device
    ne, nd = cfg.encoder_layers, cfg.num_layers
    enc_pos = _normal(gen, (cfg.num_audio_frames, d), 0.02)
    enc = {"ln1": _layernorm_params(ne, d, dev),
           "attn": attention_params(gen, cfg, ne, d),
           "ln2": _layernorm_params(ne, d, dev),
           "mlp": _gelu_mlp_params(gen, ne, d, cfg.d_ff)}
    embed = _normal(gen, (cfg.vocab_size, d), 0.02)
    dec_pos = _normal(gen, (MAX_SEQ, d), 0.02)
    dec = {"ln1": _layernorm_params(nd, d, dev),
           "self_attn": attention_params(gen, cfg, nd, d),
           "ln2": _layernorm_params(nd, d, dev),
           "cross_attn": attention_params(gen, cfg, nd, d),
           "ln3": _layernorm_params(nd, d, dev),
           "mlp": _gelu_mlp_params(gen, nd, d, cfg.d_ff)}
    return {"enc_pos": enc_pos, "enc_layers": enc,
            "enc_norm": {"scale": torch.ones(d, device=dev),
                         "bias": torch.zeros(d, device=dev)},
            "embed": embed, "dec_pos": dec_pos, "dec_layers": dec,
            "dec_norm": {"scale": torch.ones(d, device=dev),
                         "bias": torch.zeros(d, device=dev)},
            "lm_head": _dense(gen, (d, cfg.vocab_size))}


def _attn_kw(cfg: ModelConfig) -> Dict[str, Any]:
    return dict(num_heads=cfg.num_heads, num_kv=cfg.num_kv_heads,
                head_dim=cfg.resolved_head_dim, rope_theta=0.0)


def _enc_layer(lp: Params, cfg: ModelConfig,
               h: torch.Tensor) -> torch.Tensor:
    h = h + L.attention_forward(
        lp["attn"], L.layernorm(lp["ln1"], h, cfg.norm_eps),
        causal=False, **_attn_kw(cfg))
    return h + L.gelu_mlp(lp["mlp"], L.layernorm(lp["ln2"], h, cfg.norm_eps))


def encode(params: Params, cfg: ModelConfig, frames: torch.Tensor,
           remat: bool = False) -> torch.Tensor:
    """frames: (B, F, D) stubbed frontend embeddings -> encoder states;
    ``remat`` checkpoints each layer."""
    h = frames + params["enc_pos"][None, : frames.shape[1], :].to(frames.dtype)
    layer = maybe_remat(_enc_layer, remat)
    for i in range(cfg.encoder_layers):
        h = layer(layer_params(params["enc_layers"], i), cfg, h)
    return L.layernorm(params["enc_norm"], h, cfg.norm_eps)


def _proj(x: torch.Tensor, lp: Params, w: str, heads: int,
          hd: int) -> torch.Tensor:
    """``x @ W (+ b)`` split into heads: (B, S, heads, hd)."""
    y = x @ lp[w]
    if "b" + w[1:] in lp:
        y = y + lp["b" + w[1:]]
    return y.reshape(x.shape[0], x.shape[1], heads, hd)


def _cross_attend(lp: Params, cfg: ModelConfig, x: torch.Tensor,
                  enc: torch.Tensor) -> torch.Tensor:
    """Cross attention: q from decoder x, k/v from encoder states."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = _proj(x, lp, "wq", cfg.num_heads, hd)
    k = _proj(enc, lp, "wk", cfg.num_kv_heads, hd)
    v = _proj(enc, lp, "wv", cfg.num_kv_heads, hd)
    out = L._sdpa(q, k, v, None)
    return out.reshape(b, s, cfg.num_heads * hd) @ lp["wo"]


def _dec_layer(lp: Params, cfg: ModelConfig, h: torch.Tensor,
               enc: torch.Tensor) -> torch.Tensor:
    h = h + L.attention_forward(
        lp["self_attn"], L.layernorm(lp["ln1"], h, cfg.norm_eps),
        causal=True, **_attn_kw(cfg))
    h = h + _cross_attend(lp["cross_attn"], cfg,
                          L.layernorm(lp["ln2"], h, cfg.norm_eps), enc)
    return h + L.gelu_mlp(lp["mlp"], L.layernorm(lp["ln3"], h, cfg.norm_eps))


def forward(params: Params, cfg: ModelConfig, frames: torch.Tensor,
            tokens: torch.Tensor, *, remat: bool = False,
            last_only: bool = False) -> torch.Tensor:
    """Teacher-forced enc-dec forward -> logits (B, S, V) float32 ((B, 1,
    V) with ``last_only``); ``remat`` checkpoints each encoder and decoder
    layer."""
    enc = encode(params, cfg, frames, remat)
    s = tokens.shape[1]
    h = params["embed"][tokens] + \
        params["dec_pos"][None, :s, :].to(params["embed"].dtype)
    layer = maybe_remat(_dec_layer, remat)
    for i in range(cfg.num_layers):
        h = layer(layer_params(params["dec_layers"], i), cfg, h, enc)
    h = L.layernorm(params["dec_norm"], h, cfg.norm_eps)
    if last_only:
        h = h[:, -1:]
    return (h @ params["lm_head"]).float()


# ---------------------------------------------------------------------------
# decode: self-attention KV cache + precomputed cross-attention K/V
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               dtype=torch.bfloat16, device="cuda") -> Params:
    hd = cfg.resolved_head_dim
    self_shape = (cfg.num_layers, batch, seq_len, cfg.num_kv_heads, hd)
    cross_shape = (cfg.num_layers, batch, cfg.num_audio_frames,
                   cfg.num_kv_heads, hd)

    def z(shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {"k": z(self_shape), "v": z(self_shape),
            "ck": z(cross_shape), "cv": z(cross_shape), "pos": 0}


def precompute_cross(params: Params, cfg: ModelConfig, frames: torch.Tensor,
                     cache: Params) -> Params:
    """Encode once and write each layer's cross K/V into ``cache`` (in
    place, rounded to the cache dtype)."""
    enc = encode(params, cfg, frames)
    hd = cfg.resolved_head_dim
    for i in range(cfg.num_layers):
        ca = layer_params(params["dec_layers"], i)["cross_attn"]
        cache["ck"][i] = _proj(enc, ca, "wk", cfg.num_kv_heads, hd)
        cache["cv"][i] = _proj(enc, ca, "wv", cfg.num_kv_heads, hd)
    return cache


def decode_step(params: Params, cfg: ModelConfig, token: torch.Tensor,
                cache: Params) -> Tuple[torch.Tensor, Params]:
    """token (B, 1) -> (logits (B, V) float32, cache advanced by one row):
    self-attention through the drain path's decode kernel, cross
    attention against the precomputed K/V (all valid, non-causal)."""
    pos = cache["pos"]
    h = params["embed"][token] + params["dec_pos"][pos][None, None]
    hd = cfg.resolved_head_dim
    b = token.shape[0]
    for i in range(cfg.num_layers):
        lp = layer_params(params["dec_layers"], i)
        h = h + L.attention_decode(
            lp["self_attn"], L.layernorm(lp["ln1"], h, cfg.norm_eps),
            cache["k"][i], cache["v"][i], pos, **_attn_kw(cfg))
        ca = lp["cross_attn"]
        q = _proj(L.layernorm(lp["ln2"], h, cfg.norm_eps), ca, "wq",
                  cfg.num_heads, hd)
        c = L._sdpa(q, cache["ck"][i], cache["cv"][i], None)
        h = h + c.reshape(b, 1, cfg.num_heads * hd) @ ca["wo"]
        h = h + L.gelu_mlp(lp["mlp"], L.layernorm(lp["ln3"], h, cfg.norm_eps))
    h = L.layernorm(params["dec_norm"], h, cfg.norm_eps)
    logits = (h[:, 0, :] @ params["lm_head"]).float()
    return logits, dict(cache, pos=pos + 1)
