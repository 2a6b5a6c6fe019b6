"""Architecture registry of the port: ``--config <id>`` resolution.

The registry holds every architecture of the JAX package. The port's model
stack runs the decoder-only configs made of ``ATTN``, ``ATTN_LOCAL``,
``MAMBA`` and ``RWKV`` mixers with ``MLP``, ``MOE`` and ``RWKV_CM`` FFNs,
rmsnorm or layernorm, RoPE or no positions
(``configs/base.py::check_supported``); building params for, or running,
whisper-base (an encoder, sinusoidal positions, a plain gelu) raises.
internvl2-1b's text path runs; its prefix embeddings are not ported.

``PORT_ARCHITECTURES`` holds the configs the port runs that the JAX
package has not (sdar-30b-a3b); ``get_config`` resolves both.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import (
    dream_7b,
    gemma2_27b,
    gemma_7b,
    internvl2_1b,
    jamba_v01_52b,
    kimi_k2_1t,
    llada_8b,
    llama4_maverick_400b,
    qwen1_5_110b,
    qwen2_0_5b,
    rwkv6_1_6b,
    sdar_30b_a3b,
    whisper_base,
)
from repro_torch.configs.base import ModelConfig

ARCHITECTURES: Dict[str, ModelConfig] = {
    "qwen2-0.5b": qwen2_0_5b.CONFIG,
    "dream-7b": dream_7b.CONFIG,
    "llada-8b": llada_8b.CONFIG,
    "gemma-7b": gemma_7b.CONFIG,
    "gemma2-27b": gemma2_27b.CONFIG,
    "internvl2-1b": internvl2_1b.CONFIG,
    "jamba-v0.1-52b": jamba_v01_52b.CONFIG,
    "kimi-k2-1t-a32b": kimi_k2_1t.CONFIG,
    "llama4-maverick-400b-a17b": llama4_maverick_400b.CONFIG,
    "qwen1.5-110b": qwen1_5_110b.CONFIG,
    "rwkv6-1.6b": rwkv6_1_6b.CONFIG,
    "whisper-base": whisper_base.CONFIG,
}

PORT_ARCHITECTURES: Dict[str, ModelConfig] = {
    "sdar-30b-a3b": sdar_30b_a3b.CONFIG,
}


def get_config(arch: str) -> ModelConfig:
    known = {**ARCHITECTURES, **PORT_ARCHITECTURES}
    if arch not in known:
        raise KeyError(f"unknown architecture {arch!r}; available: "
                       f"{sorted(known)}")
    return known[arch]
