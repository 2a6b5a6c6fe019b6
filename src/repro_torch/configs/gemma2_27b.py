"""Gemma2-27B [dense] — alternating local(4096-window)/global attention,
attn & final logit softcaps [arXiv:2408.00118]."""
from repro_torch.configs.base import ATTN, ATTN_LOCAL, MLP, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=36_864,
    vocab_size=256_000,
    activation="gelu",
    layer_period=((ATTN_LOCAL, MLP), (ATTN, MLP)),
    sliding_window=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    query_pre_attn_scalar=144.0,   # d_model / n_heads
    embed_scale=True,
    tie_embeddings=True,
    # long_500k: local layers are natively sub-quadratic; global layers use
    # the sequence-parallel sharded cache.
    long_context_window=None,
    mask_token_id=255_999,
    eos_token_id=1,
)
