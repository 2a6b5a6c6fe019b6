"""Qwen2-0.5B [dense] — GQA, QKV bias [arXiv:2407.10671]."""
from repro_torch.configs.base import ATTN, MLP, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151_936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    activation="silu",
    layer_period=((ATTN, MLP),),
    tie_embeddings=True,
    # sliding-window decode variant enabling long_500k
    long_context_window=8_192,
    mask_token_id=151_935,
    eos_token_id=151_645,
)
