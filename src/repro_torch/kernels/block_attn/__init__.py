from repro_torch.kernels.block_attn.ops import (  # noqa: F401
    flash_block_attention,
)
