"""RWKV6-1.6B "Finch" [ssm] — attention-free, data-dependent decay
[arXiv:2404.05892].

CDLM applicability: NONE (strictly causal recurrent backbone — no
bidirectional teacher exists and decode is already O(1)/token). Implemented
as a causal LM. long_500k is natural (constant state).
"""
from repro_torch.configs.base import RWKV, RWKV_CM, ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,               # 2048 / head_size 64
    n_kv_heads=32,
    head_dim=64,
    d_ff=7168,
    vocab_size=65_536,
    activation="relu_sq",     # RWKV channel-mix uses squared ReLU
    layer_period=((RWKV, RWKV_CM),),
    rwkv_head_size=64,
    pos_embed="none",         # recurrence encodes position

    norm_type="layernorm",
    mask_token_id=65_535,
    eos_token_id=0,
)
