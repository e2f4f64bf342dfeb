"""llava-next-34b — VLM decoder with anyres tiling [hf:llava-hf/llava-v1.6-*].

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.  The vision tower +
projector are a STUB per the assignment carve-out: input_specs provides
precomputed anyres patch embeddings (batch, num_patches, d_model) which the
decoder consumes as a prefix.
"""
from repro_torch.configs.base import VLM, ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family=VLM,
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=20_480,
    vocab_size=64_000,
    num_patches=2880,   # anyres: base 576 patches x up-to-4 tiles + base image
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf (34b variant dims)",
)
