"""InternVL2-1B [vlm] — InternViT + Qwen2-0.5B LM backbone [arXiv:2404.16821].

Per the brief, the vision encoder (InternViT-300M) + MLP projector are a STUB:
``input_specs()`` supplies 256 pre-computed patch embeddings of shape
(batch, 256, d_model) which the LM consumes as a prompt prefix. The config
below describes the transformer backbone that consumes them.
"""
from repro_torch.configs.base import ATTN, MLP, ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151_655,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    activation="silu",
    layer_period=((ATTN, MLP),),
    n_prefix_embeds=256,      # ViT patch tokens (stub frontend)
    long_context_window=8_192,
    mask_token_id=151_654,
    eos_token_id=151_645,
)
