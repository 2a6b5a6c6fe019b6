"""Gemma-7B [dense] — GeGLU, head_dim=256, 16 KV heads [arXiv:2403.08295]."""
from repro_torch.configs.base import ATTN, MLP, ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24_576,
    vocab_size=256_000,
    activation="gelu",        # GeGLU
    layer_period=((ATTN, MLP),),
    embed_scale=True,
    tie_embeddings=True,
    long_context_window=8_192,
    mask_token_id=255_999,
    eos_token_id=1,
)
