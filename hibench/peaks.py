"""Peaks of one NVIDIA H100 SXM (80 GB HBM3), from NVIDIA's data sheet:
dense rates without sparsity, at the card's full 700 W limit.  A card set
to a lower power limit runs slower under load: the run's device line
reports the limit beside every number."""

BF16_FLOP_PER_S = 989e12      # bf16 / fp16 on the tensor cores
F32_FLOP_PER_S = 67e12        # float32 FMA outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
HBM_BYTES = 80e9
