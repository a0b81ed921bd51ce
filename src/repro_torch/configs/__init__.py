"""Architecture registry. Importing this package registers the configs the
port runs so far (qwen2-7b, mixtral-8x7b, arctic-480b, zamba2-1.2b and
rwkv6-7b for serving, spion-lra for training); the other architectures
arrive with their families."""
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
    mixtral_8x7b,
    qwen2_7b,
    rwkv6_7b,
    spion_lra,
    zamba2_1_2b,
)
