from repro_torch.configs.base import ModelConfig, ServeConfig  # noqa: F401
from repro_torch.configs.registry import ARCHITECTURES, get_config  # noqa: F401
