"""Llama-4-Maverick-400B-A17B [moe] — 128 experts top-1, interleaved MoE/dense,
early fusion [hf:meta-llama/Llama-4-Scout-17B-16E family].

Alternating dense/MoE FFN layers (Maverick interleave); chunked-attention
long-context variant mapped to ``long_context_window`` for long_500k.
"""
from repro_torch.configs.base import ATTN, MLP, MOE, ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202_048,
    rope_theta=500_000.0,
    activation="silu",
    n_experts=128,
    experts_per_token=1,
    moe_d_ff=8192,
    n_shared_experts=1,       # Llama-4 routed + shared expert
    layer_period=((ATTN, MLP), (ATTN, MOE)),
    long_context_window=8_192,   # chunked-attention analog
    mask_token_id=202_047,
    eos_token_id=2,
)
