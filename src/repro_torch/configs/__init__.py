"""Architecture registry. Importing this package registers every
architecture of the JAX package (one module per architecture, plus the
paper's own spion-lra)."""
from repro_torch.configs.base import (  # noqa: F401
    SHAPES,
    ModelConfig,
    MoEConfig,
    ShapeSpec,
    SpionConfig,
    SSMConfig,
    all_configs,
    get_config,
    register,
)

from repro_torch.configs import (  # noqa: F401,E402
    arctic_480b,
    command_r_35b,
    internvl2_2b,
    mistral_large_123b,
    mixtral_8x7b,
    qwen2_5_14b,
    qwen2_7b,
    rwkv6_7b,
    spion_lra,
    whisper_tiny,
    zamba2_1_2b,
)

ARCH_IDS = sorted(all_configs().keys())
