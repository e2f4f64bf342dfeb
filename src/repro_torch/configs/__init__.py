from repro_torch.configs.base import (  # noqa: F401
    DENSE, MOE, SSM, HYBRID, ENCDEC, VLM, FAMILIES, HIConfig, ModelConfig,
)
