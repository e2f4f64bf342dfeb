"""Configuration dataclasses for the port (dense decoder family).

A copy of the dense-family part of the reference's ``configs/base.py``:
:class:`ModelConfig` with its ``reduced`` and ``s_variant`` derivations, and
:class:`HIConfig`.  Fields of the other families (MoE, SSM, hybrid, enc-dec,
VLM) join when those families are ported.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

DENSE = "dense"
MOE = "moe"
SSM = "ssm"
HYBRID = "hybrid"
ENCDEC = "encdec"
VLM = "vlm"

FAMILIES = (DENSE, MOE, SSM, HYBRID, ENCDEC, VLM)


@dataclass(frozen=True)
class ModelConfig:
    """One architecture of the dense decoder family."""

    name: str
    family: str
    num_layers: int
    d_model: int
    vocab_size: int
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0                  # 0 -> d_model // num_heads
    d_ff: int = 0
    qkv_bias: bool = False
    sliding_window: int = 0            # 0 -> full causal attention
    local_global_ratio: int = 0        # gemma3: N local layers per 1 global
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    source: str = ""                   # citation for the config numbers

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.num_heads:
            return self.d_model // self.num_heads
        return 0

    def reduced(self, *, num_layers: int = 2, d_model: int = 256,
                vocab: int = 512) -> "ModelConfig":
        """Smoke-test variant of the same architecture (<= 2 layers,
        d_model <= 512), derived exactly as the reference derives it."""
        nh = max(1, min(self.num_heads, 4))
        nkv = max(1, min(self.num_kv_heads, nh))
        hd = max(8, d_model // max(nh, 1)) if self.num_heads else 0
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=num_layers,
            d_model=d_model,
            num_heads=nh if self.num_heads else 0,
            num_kv_heads=nkv if self.num_kv_heads else 0,
            head_dim=hd,
            d_ff=4 * d_model if self.d_ff else 0,
            vocab_size=min(self.vocab_size, vocab),
            sliding_window=(min(self.sliding_window, 64)
                            if self.sliding_window else 0),
        )

    def s_variant(self, scale: int = 4) -> "ModelConfig":
        """The S tier of the HI cascade: same family, ~1/scale params."""
        d = max(128, self.d_model // scale)
        nh = max(1, self.num_heads // scale) if self.num_heads else 0
        nkv = 0
        if nh:
            nkv = max(1, min(self.num_kv_heads, nh))
            while nh % nkv:              # GQA needs kv | heads
                nkv -= 1
        return dataclasses.replace(
            self,
            name=self.name + f"-s{scale}",
            num_layers=max(2, self.num_layers // scale),
            d_model=d,
            num_heads=nh,
            num_kv_heads=nkv,
            head_dim=self.resolved_head_dim if nh else 0,
            d_ff=max(128, self.d_ff // scale) if self.d_ff else 0,
        )


@dataclass(frozen=True)
class HIConfig:
    """Paper §4 decision-rule + cost-model parameters."""

    metric: str = "max_prob"        # max_prob | margin | entropy
    theta: float = 0.607            # paper's calibrated theta* for CIFAR-10
    capacity_factor: float = 0.5    # static offload capacity / batch
    s_scale: int = 4                # S-variant reduction factor
