"""Jamba-v0.1-52B [hybrid] — Mamba+attention 7:1 interleave, MoE every other
layer, 16 experts top-2 [arXiv:2403.19887].

Period of 8 layers: attention at slot 4, Mamba elsewhere; MoE FFN on odd
slots (4 MoE layers / period -> 16 total). CDLM applies in student-only form
(block diffusion over a causal-state backbone).
"""
from repro_torch.configs.base import ATTN, MAMBA, MLP, MOE, ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab_size=65_536,
    activation="silu",
    n_experts=16,
    experts_per_token=2,
    moe_d_ff=14_336,
    layer_period=(
        (MAMBA, MLP), (MAMBA, MOE), (MAMBA, MLP), (MAMBA, MOE),
        (ATTN, MLP), (MAMBA, MOE), (MAMBA, MLP), (MAMBA, MOE),
    ),
    mamba_d_state=16,
    mamba_d_conv=4,
    mamba_expand=2,
    mask_token_id=65_535,
    eos_token_id=2,
)
