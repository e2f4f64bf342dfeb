"""zamba2-2.7b — hybrid Mamba2 backbone + shared attention blocks [arXiv:2411.15242].

54L d_model=2560 32H (GQA kv=32) d_ff=10240 vocab=32000, ssm_state=64.
The attention block weights are SHARED (applied every `shared_attn_every`
layers), per the Zamba2 design.
"""
from repro_torch.configs.base import HYBRID, ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family=HYBRID,
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=10_240,
    vocab_size=32_000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=128,
    shared_attn_every=6,
    source="Zamba2 [arXiv:2411.15242]",
)
