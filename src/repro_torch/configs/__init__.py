"""Architecture registry. Importing this package registers the configs the
port runs so far (qwen2-7b for serving, spion-lra for training); the other
architectures arrive with their families."""
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

from repro_torch.configs import qwen2_7b, spion_lra  # noqa: F401,E402
