"""Whisper-base [audio] — encoder-decoder, conv/mel frontend STUB
[arXiv:2212.04356].

The mel-spectrogram + conv feature extractor is stubbed:
``input_specs()`` provides (batch, 1500, d_model) pre-computed frame
embeddings consumed by the bidirectional encoder; we implement the decoder
transformer (self-attn + cross-attn). CDLM applies to the decoder
(block-causal self-attention; encoder states are "prompt" and cached).
long_500k is skipped for this arch: a 30 s / 1500-frame
encoder with a ~448-token decoder has no meaningful 524k-token decode state.
"""
from repro_torch.configs.base import ATTN, MLP, ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,               # decoder layers
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51_865,
    activation="gelu_plain",  # whisper MLP is non-gated GELU
    layer_period=((ATTN, MLP),),
    norm_type="layernorm",
    pos_embed="sinusoidal",
    is_encoder_decoder=True,
    n_encoder_layers=6,
    encoder_seq_len=1500,
    mask_token_id=51_864,
    eos_token_id=50_257,
)
