from repro_torch.kernels.decode_attn.ops import (  # noqa: F401
    decode_attention,
    paged_decode_attention,
)
