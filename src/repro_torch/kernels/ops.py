"""Public kernel entry points, chosen by device.

On a CPU tensor each op runs its kernel's plain PyTorch version; on a CUDA
tensor it launches the hand-written kernel or raises.  There is no switch
that turns the kernels off on the card and no fallback from a failed build
or launch to the plain version.
"""
from __future__ import annotations

from typing import Dict, Tuple, Union

import torch

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import hi_gate as _hg

# wrapper name -> the function whose ``launches`` counter it bumps
KERNELS = {"hi_gate": _hg.hi_gate_cuda,
           "decode_attention": _da.decode_attention_cuda}


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


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
