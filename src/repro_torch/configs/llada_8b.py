"""LLaDA-8B-Instruct — the paper's second target DLM.

LLaMA-like MHA backbone trained as a masked diffusion model; untied head.
"""
from repro_torch.configs.base import ATTN, MLP, ModelConfig

CONFIG = ModelConfig(
    name="llada-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,            # LLaDA uses MHA
    head_dim=128,
    d_ff=12_288,
    vocab_size=126_464,
    activation="silu",
    layer_period=((ATTN, MLP),),
    long_context_window=8_192,
    mask_token_id=126_336,
    eos_token_id=126_081,
)
