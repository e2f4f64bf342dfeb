"""h2o-danube-3-4b — llama+mistral mix with sliding-window attention [arXiv:2401.16818].

24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000.
"""
from repro_torch.configs.base import DENSE, ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family=DENSE,
    num_layers=24,
    d_model=3840,
    num_heads=32,
    num_kv_heads=8,
    d_ff=10_240,
    vocab_size=32_000,
    sliding_window=4096,
    source="H2O-Danube [arXiv:2401.16818]",
)
