"""Public kernel entry points, chosen by device.

On a CPU tensor each op runs its kernel's plain PyTorch version; on a CUDA
tensor it launches the hand-written kernel or raises.  There is no switch
that turns the kernels off on the card and no fallback from a failed build
or launch to the plain version.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple, Union

import torch

from repro_torch.kernels import copy_pages as _cp
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import hi_gate as _hg

# wrapper name -> the function whose ``launches`` counter it bumps
KERNELS = {"hi_gate": _hg.hi_gate_cuda,
           "decode_attention": _da.decode_attention_cuda,
           "decode_attention_paged": _da.decode_attention_paged_cuda,
           "decode_attention_chunk_paged":
               _da.decode_attention_chunk_paged_cuda,
           "copy_pages": _cp.copy_pages_cuda}


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"no kernel for device {t.device}")


def hi_gate(logits: torch.Tensor, theta: Union[float, torch.Tensor],
            metric: str = "max_prob"
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused confidence + argmax + threshold.  logits: (N, C).

    On the card ``theta`` must be a 0-d float32 device tensor: the kernel
    reads it through a pointer, so an online policy moves it without a
    host round trip."""
    if _on_cpu(logits):
        return _hg.hi_gate_plain(logits, theta, metric)
    return _hg.hi_gate_cuda(logits, theta, metric)


def decode_attention(q: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """Flash decode attention.  q: (B,1,H,D); cache: (B,S,K,D); valid: (S,)."""
    if _on_cpu(q):
        return _da.decode_attention_plain(q, cache_k, cache_v, valid)
    return _da.decode_attention_cuda(q, cache_k, cache_v, valid)


def decode_attention_paged(q: torch.Tensor, pool_k: torch.Tensor,
                           pool_v: torch.Tensor, block: torch.Tensor,
                           valid: torch.Tensor) -> torch.Tensor:
    """Flash decode attention over a paged pool.  q: (B,1,H,D); pools:
    (P, page, K, D); block: (B, n_pages); valid: (B, n_pages * page)."""
    if _on_cpu(q):
        return _da.decode_attention_paged_plain(q, pool_k, pool_v, block,
                                                valid)
    return _da.decode_attention_paged_cuda(q, pool_k, pool_v, block, valid)


def decode_attention_chunk_paged(q: torch.Tensor, pool_k: torch.Tensor,
                                 pool_v: torch.Tensor, block: torch.Tensor,
                                 valid: torch.Tensor) -> torch.Tensor:
    """C query tokens per slot in one pass over its pages.  q: (B,C,H,D);
    valid: (B, C, n_pages * page) positional + intra-chunk causal mask."""
    if _on_cpu(q):
        return _da.decode_attention_chunk_paged_plain(q, pool_k, pool_v,
                                                      block, valid)
    return _da.decode_attention_chunk_paged_cuda(q, pool_k, pool_v, block,
                                                 valid)


def copy_pages(pools: Sequence[torch.Tensor], src, dst) -> None:
    """Copy-on-write, in place: in every (L, P, ...) pool, pages ``dst``
    become copies of pages ``src`` (host int arrays, (0, 0) pairs pad)."""
    if _on_cpu(pools[0]):
        return _cp.copy_pages_plain(pools, src, dst)
    return _cp.copy_pages_cuda(pools, src, dst)


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
