from repro_torch.config.base import ModelConfig, ServingConfig  # noqa: F401
from repro_torch.config.registry import (  # noqa: F401
    default_reduce,
    get_config,
    get_reduced_config,
    list_archs,
    register,
)
