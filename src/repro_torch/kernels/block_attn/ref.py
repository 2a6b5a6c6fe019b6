"""Plain PyTorch version of the block-causal flash attention kernel, the
counterpart of the JAX package's ``kernels/block_attn/ref.py``.

It reads the model layout ``q (b, L, Kv, G, hd)``, ``k/v (b, L, Kv, hd)``
(query head ``(kv, g)`` reads KV head ``kv``) and keeps scores and
probabilities in fp32; the output is fp32. Note that the model's generic
attention (``models/layers.py::_dense_attention``) casts the probabilities
to the value dtype before the PV product, as the JAX package's does; this
version, like the kernel, does not.
"""
from __future__ import annotations

from typing import Optional

import torch

BIDIRECTIONAL = "bidirectional"
CAUSAL = "causal"
BLOCK_CAUSAL = "block_causal"
MODES = (BIDIRECTIONAL, CAUSAL, BLOCK_CAUSAL)
NEG_INF = -1e30


def visibility(Lq: int, Lk: int, *, mode: str, prompt_len: int,
               block_size: int, window: Optional[int],
               device=None) -> torch.Tensor:
    """(Lq, Lk) bool: query position i sees key position j."""
    q = torch.arange(Lq, device=device)[:, None]
    k = torch.arange(Lk, device=device)[None, :]
    if mode == BIDIRECTIONAL:
        vis = torch.ones((Lq, Lk), dtype=torch.bool, device=device)
    elif mode == CAUSAL:
        vis = k <= q
    elif mode == BLOCK_CAUSAL:
        def blk(pos):
            return torch.where(pos < prompt_len, -1,
                               torch.div(pos - prompt_len, block_size,
                                         rounding_mode="floor"))
        vis = blk(k) <= blk(q)
    else:
        raise ValueError(f"unknown attention mode {mode!r}")
    if window is not None:
        vis = vis & ((q - k < window) if mode == CAUSAL
                     else ((q - k).abs() < window))
    return vis


def block_attention(q, k, v, *, mode: str = BLOCK_CAUSAL,
                    prompt_len: int = 0, block_size: int = 1,
                    window: Optional[int] = None, scale: float = 1.0,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """q: (b, L, Kv, G, hd); k/v: (b, L, Kv, hd). Returns (b, L, Kv, G, hd)
    fp32."""
    s = torch.einsum("bqkgh,bskh->bkgqs", q.float(), k.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    vis = visibility(q.shape[1], k.shape[1], mode=mode,
                     prompt_len=prompt_len, block_size=block_size,
                     window=window, device=q.device)
    p = torch.softmax(torch.where(vis, s, torch.full_like(s, NEG_INF)), -1)
    return torch.einsum("bkgqs,bskh->bqkgh", p, v.float())
