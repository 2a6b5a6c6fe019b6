"""Kimi-K2-1T-A32B [moe] — trillion-param MoE, 384 experts top-8 + 1 shared,
small (2048) expert hidden dim [arXiv:2501.kimi2, paper table]."""
from repro_torch.configs.base import ATTN, MOE, ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=112,             # 7168 / 64
    d_ff=2048,
    vocab_size=163_840,
    rope_theta=50_000.0,
    activation="silu",
    n_experts=384,
    experts_per_token=8,
    moe_d_ff=2048,
    n_shared_experts=1,
    layer_period=((ATTN, MOE),),   # 61 is prime -> period must be 1
    long_context_window=8_192,
    mask_token_id=163_839,
    eos_token_id=163_586,
)
