"""arctic-480b — 128-expert top-2 MoE + dense residual [hf:Snowflake/snowflake-arctic-base].

35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000, MoE 128e top-2.
Arctic's dense-MoE hybrid: a dense FFN residual path runs in parallel with the
routed experts.
"""
from repro_torch.configs.base import MOE, ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family=MOE,
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=4864,
    d_ff_expert=4864,
    vocab_size=32_000,
    num_experts=128,
    experts_per_token=2,
    num_shared_experts=0,
    moe_dense_residual=True,
    source="hf:Snowflake/snowflake-arctic-base",
)
