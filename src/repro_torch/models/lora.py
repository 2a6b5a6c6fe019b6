"""LoRA adapters (paper App. A.2: rank 32/64 on the attention and MLP
projections), ported from the JAX package's ``models/lora.py``.

Adapters are a sparse mirror of the param tree: a dict keyed by the
"/"-joined path of each targeted matrix ("slots/0/attn/wq"), each entry
``{"a": (..., in, r), "b": (..., r, out)}`` stacked over periods like the
weight. ``merge`` materializes W + (alpha/r)·A·B for the forward.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

import torch

from repro_torch import tree as T

DEFAULT_TARGETS = ("wq", "wk", "wv", "wo", "wi_gate", "wi_up", "wi")


def _targets(params, targets):
    return [(T.key_path(path), leaf)
            for path, leaf in T.leaves_with_path(params)
            if path[-1] in targets and leaf.ndim >= 2]


def init_lora(generator: torch.Generator, params, *, rank: int,
              targets: Sequence[str] = DEFAULT_TARGETS) -> Dict[str, dict]:
    """Adapters with ``a`` drawn from ``generator`` (standard normal over
    sqrt(in)) and ``b`` zero; see :func:`lora_from_draws`."""
    draws = {name: torch.randn((*leaf.shape[:-1], rank), generator=generator,
                               device=generator.device)
             for name, leaf in _targets(params, targets)}
    return lora_from_draws(params, draws, rank=rank, targets=targets)


def lora_from_draws(params, draws: Dict[str, torch.Tensor], *, rank: int,
                    targets: Sequence[str] = DEFAULT_TARGETS):
    """Adapters from given standard-normal draws ``(..., in, rank)`` per
    target path: ``a = draw / sqrt(in)`` and ``b = 0``, in the weight's
    dtype and device."""
    lora = {}
    for name, leaf in _targets(params, targets):
        in_dim, out_dim = leaf.shape[-2], leaf.shape[-1]
        a = draws[name].to(leaf.device) / math.sqrt(in_dim)
        lora[name] = {"a": a.to(leaf.dtype),
                      "b": torch.zeros((*leaf.shape[:-2], rank, out_dim),
                                       dtype=leaf.dtype, device=leaf.device)}
    return lora


def merge(params, lora: Dict[str, dict], alpha: float, rank: int):
    """Params with W <- W + (alpha/rank) A@B on the targeted leaves."""
    scale = alpha / rank

    def fix(path, leaf):
        ab = lora.get(T.key_path(path))
        if ab is None:
            return leaf
        return leaf + (scale * (ab["a"] @ ab["b"])).to(leaf.dtype)

    return T.map_with_path(fix, params)


def param_count(lora) -> int:
    return sum(x.numel() for x in T.leaves(lora))
