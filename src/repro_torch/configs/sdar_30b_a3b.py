"""SDAR-30B-A3B-Chat [moe] — a block-diffusion LM trained from Qwen3-30B-A3B
(JetLM, https://huggingface.co/JetLM/SDAR-30B-A3B-Chat, ``model_type``
``sdar_moe``): 48 layers, GQA 32/4 at head_dim 128, every layer a MoE of
128 experts (top 8, gates renormalised, no shared expert) of width 768,
untied head.

Its layers are Qwen3-MoE's: a per-head RMSNorm of q and k before RoPE
(``qk_norm``; the published config has no key for it), and every choice of
every token computed (``moe_dispatch`` "grouped": no capacity, nothing
dropped). ``d_ff`` is the published ``intermediate_size``, which no layer
uses (``mlp_only_layers`` is empty). ``mask_token_id`` is SDAR's added
``<|MASK|>`` (assumed), ``eos_token_id`` ``<|im_end|>``. Not in the JAX
package: the port's own config.
"""
from repro_torch.configs.base import ATTN, MOE, ModelConfig

CONFIG = ModelConfig(
    name="sdar-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=6144,
    vocab_size=151_936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    activation="silu",
    n_experts=128,
    experts_per_token=8,
    moe_d_ff=768,
    moe_dispatch="grouped",
    layer_period=((ATTN, MOE),),
    norm_eps=1e-6,
    mask_token_id=151_669,
    eos_token_id=151_645,
)
