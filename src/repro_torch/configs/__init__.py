"""Architecture registry. Importing this package registers the configs the
port serves so far; the other architectures arrive with their families."""
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

from repro_torch.configs import qwen2_7b  # noqa: F401,E402
