from repro_torch.configs.base import (  # noqa: F401
    CDLMConfig,
    ModelConfig,
    ServeConfig,
    TrainConfig,
)
from repro_torch.configs.registry import ARCHITECTURES, get_config  # noqa: F401
