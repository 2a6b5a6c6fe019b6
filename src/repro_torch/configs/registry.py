"""Architecture registry of the port: ``--config <id>`` resolution.

The port serves dense decoders made of ``ATTN``/``MLP`` slots only; every
other architecture of the JAX package is refused with a clear error.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import dream_7b, llada_8b, qwen2_0_5b
from repro_torch.configs.base import ModelConfig

ARCHITECTURES: Dict[str, ModelConfig] = {
    "qwen2-0.5b": qwen2_0_5b.CONFIG,
    "dream-7b": dream_7b.CONFIG,
    "llada-8b": llada_8b.CONFIG,
}


def get_config(arch: str) -> ModelConfig:
    try:
        return ARCHITECTURES[arch]
    except KeyError:
        raise KeyError(
            f"architecture {arch!r} is not served by repro_torch, which runs "
            f"dense ATTN/MLP decoders only; available: "
            f"{sorted(ARCHITECTURES)}") from None
