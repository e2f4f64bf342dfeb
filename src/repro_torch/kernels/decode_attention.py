"""decode_attention — flash-decode GQA of one query token over a contiguous
KV cache, with a shared (S,) validity mask (position and sliding window).

Replaces the reference's ``kernels/decode_attention.py``
``decode_attention_pallas``.  The paged and chunked kernels of that module
belong to the continuous-batching slice.

* :func:`decode_attention_plain` — the plain PyTorch version, following the
  Pallas kernel's arithmetic: q stays float32, K/V are upcast to float32
  (the reference's jnp path ``layers._sdpa`` would instead cast q to the
  cache dtype), masked scores are -1e30 with their probability zeroed, and
  the result is ``acc / max(l, 1e-30)``.
* :func:`decode_attention_cuda` — launches ``csrc/decode_attention.cu``.
  ``decode_attention_cuda.launches`` counts its launches.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build

_NEG = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 256)
MAX_GROUP = 8


def _check_heads(h: int, kh: int) -> int:
    if h % kh:
        raise ValueError(f"query heads H={h} not divisible by kv heads K={kh}")
    return h // kh


def decode_attention_plain(q: torch.Tensor, cache_k: torch.Tensor,
                           cache_v: torch.Tensor,
                           valid: torch.Tensor) -> torch.Tensor:
    """q: (B, 1, H, D); cache_k/v: (B, S, K, D); valid: (S,) bool.
    Returns (B, 1, H, D) in q's dtype (float32 accumulation)."""
    b, _, h, d = q.shape
    kh = cache_k.shape[2]
    g = _check_heads(h, kh)
    qg = q.reshape(b, kh, g, d).float()
    scores = torch.einsum("bkgd,bskd->bkgs", qg, cache_k.float()) \
        * (1.0 / math.sqrt(d))
    scores = torch.where(valid, scores, _NEG)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m) * valid.float()
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgs,bskd->bkgd", p, cache_v.float())
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, 1, h, d).to(q.dtype)


def decode_attention_cuda(q: torch.Tensor, cache_k: torch.Tensor,
                          cache_v: torch.Tensor,
                          valid: torch.Tensor) -> torch.Tensor:
    """Launch the kernel.  Shapes as :func:`decode_attention_plain`; every
    tensor contiguous on one CUDA device; K/V float32 or bfloat16 of one
    dtype, each starting on a 16-byte boundary; D in ``HEAD_DIMS``;
    H/K <= ``MAX_GROUP``."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"decode_attention_cuda needs CUDA tensors, got {dev}")
    if any(t.device != dev for t in (cache_k, cache_v, valid)):
        raise ValueError("decode_attention: all operands must share a device")
    if cache_k.dtype not in _DTYPES or cache_v.dtype != cache_k.dtype:
        raise TypeError(f"decode_attention: cache dtypes {cache_k.dtype}/"
                        f"{cache_v.dtype}; need one of float32, bfloat16")
    if valid.dtype != torch.bool:
        raise TypeError(f"decode_attention: valid must be bool, got "
                        f"{valid.dtype}")
    if q.ndim != 4 or q.shape[1] != 1 or cache_k.ndim != 4:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} must be "
                         f"(B,1,H,D) and the cache (B,S,K,D)")
    b, _, h, d = q.shape
    s, kh = cache_k.shape[1], cache_k.shape[2]
    if (cache_k.shape != (b, s, kh, d) or cache_v.shape != cache_k.shape
            or valid.shape != (s,)):
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(cache_k.shape)}, v {tuple(cache_v.shape)}, "
                         f"valid {tuple(valid.shape)} do not agree")
    g = _check_heads(h, kh)
    if d not in HEAD_DIMS or g > MAX_GROUP:
        raise ValueError(f"decode_attention: head dim {d} (need one of "
                         f"{HEAD_DIMS}) or group {g} (need <= {MAX_GROUP}) "
                         f"not supported by the kernel")
    if not all(t.is_contiguous() for t in (cache_k, cache_v, valid)):
        raise ValueError("decode_attention: cache and mask must be contiguous")
    # K/V rows are staged with 16-byte loads; q is read a float at a time
    if cache_k.data_ptr() % 16 or cache_v.data_ptr() % 16:
        raise ValueError("decode_attention: cache_k and cache_v must start "
                         "on a 16-byte boundary")
    q32 = q.float().contiguous()
    out = torch.empty((b, 1, h, d), dtype=torch.float32, device=dev)
    lib = build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.decode_attention_launch(
        q32.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
        valid.data_ptr(), out.data_ptr(), _DTYPES[cache_k.dtype], b, s, kh, g,
        d, 1.0 / math.sqrt(d), stream)
    build.check(err, "decode_attention")
    decode_attention_cuda.launches += 1
    return out.to(q.dtype)


decode_attention_cuda.launches = 0
