from repro_torch.configs.base import (  # noqa: F401
    A100,
    H100,
    H100_FP32_FLOPS,
    CDLMConfig,
    HardwareConfig,
    ModelConfig,
    ServeConfig,
    TrainConfig,
)
from repro_torch.configs.registry import ARCHITECTURES, get_config  # noqa: F401
