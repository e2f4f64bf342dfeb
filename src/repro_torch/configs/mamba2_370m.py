"""mamba2-370m — SSD (state-space duality) [arXiv:2405.21060].

48L d_model=1024, attention-free, d_ff=0, vocab=50280, ssm_state=128.
"""
from repro_torch.configs.base import SSM, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family=SSM,
    num_layers=48,
    d_model=1024,
    vocab_size=50_280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=128,
    ssm_conv_width=4,
    ssm_ngroups=1,
    source="SSD / Mamba-2 [arXiv:2405.21060]",
)
