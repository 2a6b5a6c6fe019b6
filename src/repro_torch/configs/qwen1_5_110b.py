"""Qwen1.5-110B [dense] — 80L, GQA kv=8, QKV bias [hf:Qwen/Qwen1.5-110B]."""
from repro_torch.configs.base import ATTN, MLP, ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=49_152,
    vocab_size=152_064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    activation="silu",
    layer_period=((ATTN, MLP),),
    long_context_window=8_192,
    mask_token_id=152_063,
    eos_token_id=151_645,
)
