"""deepseek-moe-16b — fine-grained MoE, 2 shared + 64 routed top-6 [arXiv:2401.06066].

28L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=102400, MoE 64e top-6.
"""
from repro_torch.configs.base import MOE, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family=MOE,
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    d_ff_expert=1408,
    vocab_size=102_400,
    num_experts=64,
    experts_per_token=6,
    num_shared_experts=2,
    source="DeepSeekMoE [arXiv:2401.06066]",
)
