from repro_torch.kernels.moe.ops import (  # noqa: F401
    grouped_experts,
    moe_align,
    moe_combine,
    moe_down,
    moe_gate_up,
    moe_gather,
)
