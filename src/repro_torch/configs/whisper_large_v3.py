"""whisper-large-v3 — encoder-decoder audio model [arXiv:2212.04356].

32L d_model=1280 20H (GQA kv=20) d_ff=5120 vocab=51866; conv/mel frontend is a
STUB per the assignment carve-out — input_specs provides precomputed frame
embeddings of shape (batch, num_audio_frames, d_model).
"""
from repro_torch.configs.base import ENCDEC, ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family=ENCDEC,
    num_layers=32,            # decoder layers
    encoder_layers=32,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    d_ff=5120,
    vocab_size=51_866,
    num_audio_frames=1500,
    qkv_bias=True,
    source="Whisper [arXiv:2212.04356]",
)
