from repro_torch.models.transformer import (  # noqa: F401
    ModelOutput,
    forward,
    unembed_matrix,
)
