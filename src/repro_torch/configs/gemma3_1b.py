"""gemma3-1b — dense, 5:1 local:global attention [hf:google/gemma-3-1b-pt].

26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144.  Local layers use a
1024-token sliding window; every 6th layer is global.
"""
from repro_torch.configs.base import DENSE, ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    family=DENSE,
    num_layers=26,
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262_144,
    sliding_window=1024,
    local_global_ratio=5,
    rope_theta=1_000_000.0,
    source="hf:google/gemma-3-1b-pt",
)
