from repro_torch.config.base import (  # noqa: F401
    INPUT_SHAPES,
    InputShape,
    ModelConfig,
    ServingConfig,
)
from repro_torch.config.registry import (  # noqa: F401
    default_reduce,
    get_config,
    get_reduced_config,
    list_archs,
    register,
)
