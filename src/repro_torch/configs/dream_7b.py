"""Dream-7B-Instruct — the paper's primary target DLM [arXiv:2508.15487].

Qwen2.5-7B-derived backbone adapted to masked diffusion; untied head.
"""
from repro_torch.configs.base import ATTN, MLP, ModelConfig

CONFIG = ModelConfig(
    name="dream-7b",
    family="dense",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18_944,
    vocab_size=152_064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    activation="silu",
    layer_period=((ATTN, MLP),),
    long_context_window=8_192,
    mask_token_id=151_666,
    eos_token_id=151_645,
)
