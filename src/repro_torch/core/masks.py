"""Attention-visibility builders (paper Fig. 2), as in the JAX package.

Three modes:

- ``bidirectional``: every position attends everywhere (DLM teacher).
- ``block_causal``: a position attends to the prompt, every completed block
  before its own, and every position of its own block (CDLM student).
  Block index of position p >= prompt_len is ``(p - prompt_len) //
  block_size``; prompt positions form block -1.
- ``causal``: the autoregressive mask.

Visibility is a predicate over (query positions, key positions). Positions
broadcast: ``(L,)`` for a batch that shares positions, ``(b, L)`` for
per-lane positions (lanes decoding at different block offsets); the
result is ``(..., Lq, Lk)``.
"""
from __future__ import annotations

from typing import Optional

import torch

BIDIRECTIONAL = "bidirectional"
BLOCK_CAUSAL = "block_causal"
CAUSAL = "causal"

NEG_INF = -1e30  # finite "minus infinity" keeps softmax NaN-free on empty rows


def block_index(pos: torch.Tensor, prompt_len: int, block_size: int):
    """Block id of each position; prompt (pos < prompt_len) -> -1."""
    blk = torch.div(pos - prompt_len, block_size, rounding_mode="floor")
    return torch.where(pos < prompt_len, torch.full_like(blk, -1), blk)


def visible(q_pos: torch.Tensor, kv_pos: torch.Tensor, *, mode: str,
            prompt_len: int = 0, block_size: int = 1,
            window: Optional[int] = None) -> torch.Tensor:
    """Boolean visibility ``(..., Lq, Lk)``.

    ``window`` intersects a sliding window: ``0 <= q-k < window`` for
    ``causal``; symmetric ``|q-k| < window`` for the (block-)bidirectional
    modes, so within-block future positions stay visible.
    """
    q = q_pos[..., :, None]
    k = kv_pos[..., None, :]
    if mode == BIDIRECTIONAL:
        vis = torch.ones(torch.broadcast_shapes(q.shape, k.shape),
                         dtype=torch.bool, device=q.device)
    elif mode == CAUSAL:
        vis = k <= q
    elif mode == BLOCK_CAUSAL:
        vis = (block_index(k, prompt_len, block_size)
               <= block_index(q, prompt_len, block_size))
    else:
        raise ValueError(f"unknown mask mode {mode!r}")
    if window is not None:
        if mode == CAUSAL:
            vis = vis & (q - k < window)
        else:
            vis = vis & ((q - k).abs() < window)
    return vis


def bias_from_visible(vis: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros((), dtype=torch.float32, device=vis.device)
    return torch.where(vis, zero, torch.full_like(zero, NEG_INF))


def make_bias_fn(*, mode: str, prompt_len: int = 0, block_size: int = 1,
                 window: Optional[int] = None):
    """Returns ``f(q_pos, kv_pos) -> additive fp32 bias (..., Lq, Lk)``."""

    def f(q_pos, kv_pos):
        return bias_from_visible(visible(q_pos, kv_pos, mode=mode,
                                         prompt_len=prompt_len,
                                         block_size=block_size,
                                         window=window))

    return f
