"""Plain PyTorch versions of the fused unembed + select kernel.

``select_ref`` is the dense baseline: full ``(T, V)`` fp32 logits, softmax,
first-occurrence argmax and the probability of the argmax.
``select_streaming`` is the kernel's online algorithm over vocab chunks:
running max ``m``, rescaled sum-exp ``l`` and first-occurrence argmax
``i`` (lowest index within a chunk, strict ``>`` across chunks), so the
argmax's probability is ``1 / l``. Both follow the JAX package's
``kernels/select/ref.py``, with the unembedding in the port's ``(V, d)``
row layout. Finalized rows (``masked`` False) get ``-inf`` confidence.
"""
from __future__ import annotations

from typing import Optional

import torch


def _softcap(x, cap: Optional[float]):
    return x if cap is None else cap * torch.tanh(x / cap)


def select_ref(hidden, w, masked, *, softcap: Optional[float] = None):
    """hidden: (T, d); w: (V, d); masked: (T,) bool
    -> (cand (T,) int32, conf (T,) fp32)."""
    logits = _softcap(hidden.float() @ w.float().t(), softcap)
    probs = torch.softmax(logits, dim=-1)
    cand = torch.argmax(logits, dim=-1)   # first occurrence, as jnp.argmax
    conf = probs.gather(-1, cand[:, None])[:, 0]
    return cand.to(torch.int32), torch.where(
        masked, conf, torch.full_like(conf, -torch.inf))


def select_streaming(hidden, w, masked, *, softcap: Optional[float] = None,
                     chunk: int = 4096):
    """Vocab-chunked running (max, sum-exp, argmax); no (T, V) tensor."""
    T, V = hidden.shape[0], w.shape[0]
    hf = hidden.float()
    m = torch.full((T,), -torch.inf, device=hidden.device)
    l = torch.zeros((T,), device=hidden.device)
    best = torch.zeros((T,), dtype=torch.int64, device=hidden.device)
    for j in range(0, V, chunk):
        lo = _softcap(hf @ w[j:j + chunk].float().t(), softcap)
        tile_m = lo.amax(dim=-1)
        tile_i = torch.argmax(lo, dim=-1)   # first occurrence in the chunk
        m_new = torch.maximum(m, tile_m)
        alpha = torch.where(torch.isfinite(m), torch.exp(m - m_new),
                            torch.zeros_like(m))
        l = l * alpha + torch.exp(lo - m_new[:, None]).sum(-1)
        best = torch.where(tile_m > m, tile_i + j, best)
        m = m_new
    conf = 1.0 / l
    return best.to(torch.int32), torch.where(
        masked, conf, torch.full_like(conf, -torch.inf))
