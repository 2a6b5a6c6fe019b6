"""Plain PyTorch versions of the fused cross-entropy kernels.

``xent_ref`` is the oracle: full ``(T, V)`` fp32 logits, ``logsumexp``
minus the target logit, as the JAX package's ``kernels/xent/ref.py``.
``xent_streaming`` is the kernel's forward algorithm over vocab chunks: a
running max ``m`` and rescaled sum-exp ``l`` per row, with the target logit
gathered from the chunk that holds it. ``xent_backward`` is the two-pass
chunked backward of the JAX ``kernels/xent/ops.py::_bwd``: the logsumexp
statistics (unless given), then per chunk ``e = exp(lo - logz) * g``,
``dh += e W_chunk`` and ``dW_chunk = (e - 1[v = y] g)^T h``; the one-hot
part of dh, ``g W_y``, is subtracted once after the vocab sum (the same
function as the JAX ``p = (exp(.) - 1[v = y]) g``, without a large term in
the long fp32 sum). The unembedding is in the port's ``(V, d)`` row
layout.
"""
from __future__ import annotations

import torch

CHUNK = 4096


def xent_ref(hidden, w, targets, softcap=None):
    """hidden: (T, d); w: (V, d); targets: (T,) -> loss (T,) fp32. With
    ``softcap``, the logits are ``softcap * tanh(logits / softcap)`` first
    (a final-logit softcap, as the reference's logits-based loss)."""
    logits = hidden.float() @ w.float().t()
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    return (torch.logsumexp(logits, -1)
            - logits.gather(-1, targets.long()[:, None])[:, 0])


def xent_streaming(hidden, w, targets, chunk: int = CHUNK):
    """Vocab-chunked online logsumexp; no (T, V) tensor. Returns
    (loss (T,), logz (T,)), both fp32."""
    T, V = hidden.shape[0], w.shape[0]
    hf = hidden.float()
    y = targets.long()
    m = torch.full((T,), -torch.inf, device=hidden.device)
    l = torch.zeros((T,), device=hidden.device)
    tgt = torch.zeros((T,), device=hidden.device)
    for j in range(0, V, chunk):
        lo = hf @ w[j:j + chunk].float().t()
        here = (y >= j) & (y < j + lo.shape[1])
        at = lo.gather(1, (y - j).clamp(0, lo.shape[1] - 1)[:, None])[:, 0]
        tgt = tgt + torch.where(here, at, torch.zeros_like(at))
        m_new = torch.maximum(m, lo.amax(dim=-1))
        alpha = torch.where(torch.isfinite(m), torch.exp(m - m_new),
                            torch.zeros_like(m))
        l = l * alpha + torch.exp(lo - m_new[:, None]).sum(-1)
        m = m_new
    logz = m + torch.log(l.clamp_min(1e-30))
    return logz - tgt, logz


def xent_backward(hidden, w, targets, g, logz=None, *, need_dw: bool = True,
                  chunk: int = CHUNK):
    """Gradients of ``sum_t g[t] * loss[t]``: (dh (T, d) in hidden's dtype,
    dW (V, d) in w's dtype, or None without ``need_dw``). ``logz`` (T,)
    skips the statistics pass."""
    T, V = hidden.shape[0], w.shape[0]
    hf = hidden.float()
    y = targets.long()
    g = g.float()
    if logz is None:
        _, logz = xent_streaming(hidden, w, targets, chunk)
    dh = torch.zeros_like(hf)
    dw = (torch.empty((V, hf.shape[1]), device=hidden.device)
          if need_dw else None)
    for j in range(0, V, chunk):
        wj = w[j:j + chunk].float()
        e = torch.exp(hf @ wj.t() - logz[:, None]) * g[:, None]
        dh = dh + e @ wj
        if need_dw:
            vpos = torch.arange(j, j + wj.shape[0], device=hidden.device)
            p = e - (vpos[None, :] == y[:, None]).float() * g[:, None]
            dw[j:j + wj.shape[0]] = p.t() @ hf
    dh = dh - g[:, None] * w[y].float()
    return dh.to(hidden.dtype), None if dw is None else dw.to(w.dtype)
