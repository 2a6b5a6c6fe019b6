from repro_torch.kernels.select.ops import fused_select  # noqa: F401
