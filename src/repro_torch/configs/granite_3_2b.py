"""granite-3-2b — dense GQA [hf:ibm-granite/granite-3.0-2b-base].

40L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=49155.
"""
from repro_torch.configs.base import DENSE, ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b",
    family=DENSE,
    num_layers=40,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=49_155,
    source="hf:ibm-granite/granite-3.0-2b-base",
)
