"""Configuration dataclasses of the port.

A copy of the reference's ``configs/base.py``: :class:`ModelConfig` of every
family (dense, MoE, SSM, hybrid, enc-dec, VLM) with its ``reduced`` and
``s_variant`` derivations, field for field, :class:`HIConfig`,
:class:`TrainConfig` and the assigned input shapes :class:`ShapeConfig`
(``SHAPES``), which the partition rules of ``sharding/specs.py`` read.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

# ---------------------------------------------------------------------------
# Families
# ---------------------------------------------------------------------------
DENSE = "dense"
MOE = "moe"
SSM = "ssm"
HYBRID = "hybrid"
ENCDEC = "encdec"   # whisper-style audio encoder-decoder
VLM = "vlm"         # llava-style decoder with patch-embedding prefix

FAMILIES = (DENSE, MOE, SSM, HYBRID, ENCDEC, VLM)


@dataclass(frozen=True)
class ModelConfig:
    """One architecture.  Fields unused by a family stay at their defaults."""

    name: str
    family: str
    num_layers: int
    d_model: int
    vocab_size: int
    # -- attention ----------------------------------------------------------
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0                  # 0 -> d_model // num_heads
    d_ff: int = 0
    qkv_bias: bool = False
    sliding_window: int = 0            # 0 -> full causal attention
    local_global_ratio: int = 0        # gemma3: N local layers per 1 global
    rope_theta: float = 10_000.0
    # -- MoE -----------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0        # deepseek fine-grained shared experts
    d_ff_expert: int = 0               # routed-expert hidden size
    moe_dense_residual: bool = False   # arctic: dense FFN residual in parallel
    router_aux_coef: float = 0.01
    # -- SSM (mamba2 / SSD) ---------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    ssm_conv_width: int = 4
    ssm_ngroups: int = 1
    # -- hybrid (zamba2) ------------------------------------------------------
    shared_attn_every: int = 0         # insert the shared attn block every k layers
    # -- encoder-decoder (whisper) --------------------------------------------
    encoder_layers: int = 0
    num_audio_frames: int = 1500       # stubbed conv/mel frontend output length
    # -- VLM (llava) -----------------------------------------------------------
    num_patches: int = 0               # stubbed vision-tower patch embeddings
    # -- misc -------------------------------------------------------------------
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    source: str = ""                   # citation for the config numbers

    # ---- derived -----------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.num_heads:
            return self.d_model // self.num_heads
        return 0

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def attention_free(self) -> bool:
        return self.family == SSM

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k shape (bounded per-token attention cost)."""
        if self.family in (SSM, HYBRID):
            return True
        if self.family == DENSE and (self.sliding_window or self.local_global_ratio):
            return True
        return False

    def reduced(self, *, num_layers: int = 2, d_model: int = 256,
                num_experts: int = 4, vocab: int = 512) -> "ModelConfig":
        """Smoke-test variant of the same family (assignment: <=2 layers,
        d_model<=512, <=4 experts)."""
        nh = max(1, min(self.num_heads, 4))
        nkv = max(1, min(self.num_kv_heads, nh))
        hd = max(8, d_model // max(nh, 1)) if self.num_heads else 0
        changes = dict(
            name=self.name + "-smoke",
            num_layers=num_layers,
            d_model=d_model,
            num_heads=nh if self.num_heads else 0,
            num_kv_heads=nkv if self.num_kv_heads else 0,
            head_dim=hd,
            d_ff=4 * d_model if self.d_ff else 0,
            vocab_size=min(self.vocab_size, vocab),
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
        )
        if self.num_experts:
            changes.update(
                num_experts=min(self.num_experts, num_experts),
                experts_per_token=min(self.experts_per_token, 2),
                num_shared_experts=min(self.num_shared_experts, 1),
                d_ff_expert=2 * d_model if self.d_ff_expert else 0,
            )
        if self.family in (SSM, HYBRID):
            changes.update(ssm_state=min(self.ssm_state, 16), ssm_head_dim=16,
                           ssm_chunk=32)
        if self.family == HYBRID:
            changes.update(shared_attn_every=2)
        if self.family == ENCDEC:
            changes.update(encoder_layers=2, num_audio_frames=16)
        if self.family == VLM:
            changes.update(num_patches=8)
        return dataclasses.replace(self, **changes)

    def s_variant(self, scale: int = 4) -> "ModelConfig":
        """The S-ML tier for the HI cascade: same family, ~1/scale params."""
        d = max(128, self.d_model // scale)
        nh = max(1, self.num_heads // scale) if self.num_heads else 0
        nkv = 0
        if nh:
            nkv = max(1, min(self.num_kv_heads, nh))
            while nh % nkv:              # GQA needs kv | heads
                nkv -= 1
        changes = dict(
            name=self.name + f"-s{scale}",
            num_layers=max(2, self.num_layers // scale),
            d_model=d,
            num_heads=nh,
            num_kv_heads=nkv,
            head_dim=self.resolved_head_dim if nh else 0,
            d_ff=max(128, self.d_ff // scale) if self.d_ff else 0,
        )
        if self.num_experts:
            changes.update(num_experts=max(4, self.num_experts // scale),
                           d_ff_expert=max(64, self.d_ff_expert // scale))
        if self.family == ENCDEC:
            changes.update(encoder_layers=max(2, self.encoder_layers // scale))
        return dataclasses.replace(self, **changes)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input shape."""

    name: str
    seq_len: int
    global_batch: int
    mode: str                     # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.mode == "decode"


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


@dataclass(frozen=True)
class HIConfig:
    """Paper §4 decision-rule + cost-model parameters."""

    metric: str = "max_prob"        # max_prob | margin | entropy
    theta: float = 0.607            # paper's calibrated theta* for CIFAR-10
    beta: float = 0.5               # offload cost in [0, 1)
    capacity_factor: float = 0.5    # static offload capacity / batch
    s_scale: int = 4                # S-variant reduction factor
    binary_relevance: bool = False  # dog-breed rule: offload iff p >= theta


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 1000
    grad_clip: float = 1.0
    grad_accum: int = 1            # microbatch accumulation
    adam_b1: float = 0.9
    adam_b2: float = 0.95
    adam_eps: float = 1e-8
    bf16_state: bool = True        # keep Adam moments in bf16 (memory)
    factored_v: bool = False       # Adafactor-style factored second moment
                                   # (row+col stats for matrices — kills the
                                   # per-param v buffer on 100B+ models)
    accum_dtype: str = "float32"   # grad-accumulation buffer dtype
    remat: bool = True
    seed: int = 0
