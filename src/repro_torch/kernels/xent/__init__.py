from repro_torch.kernels.xent.ops import fused_xent  # noqa: F401
