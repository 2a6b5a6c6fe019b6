from repro_torch.configs.base import (  # noqa: F401
    A100,
    DGX_H100,
    H100,
    H100_FP32_FLOPS,
    INPUT_SHAPES,
    CDLMConfig,
    Fabric,
    HardwareConfig,
    ModelConfig,
    ServeConfig,
    ShapeConfig,
    TrainConfig,
)
from repro_torch.configs.registry import (  # noqa: F401
    ARCHITECTURES,
    PORT_ARCHITECTURES,
    get_config,
)
