"""The masking of the forward process (Eq. 6 setup), greedy candidate
selection and finalization rules (paper §4.3), ported from the JAX
package's ``core/diffusion.py``. Greedy only: sampled decoding is not
ported yet."""
from __future__ import annotations

import torch

from repro_torch.kernels.select import fused_select


def uniform(generator: torch.Generator, shape, device, low: float = 0.0,
            high: float = 1.0) -> torch.Tensor:
    """fp32 uniform draws on [low, high), drawn on the generator's device
    and placed on ``device``."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return (low + (high - low) * u).to(device)


def mask_tokens(generator: torch.Generator, tokens, t, mask_id: int,
                maskable=None):
    """Independently mask each token with probability ``t``: draws ``u``
    from ``generator`` and applies :func:`mask_tokens_from`."""
    u = uniform(generator, tuple(tokens.shape), tokens.device)
    return mask_tokens_from(u, tokens, t, mask_id, maskable)


def mask_tokens_from(u, tokens, t, mask_id: int, maskable=None):
    """The masking given its uniform draws ``u`` (tokens' shape): position
    i is masked where ``u_i < t`` (and ``maskable``). tokens: (..., L);
    t: scalar or (...,) masking ratio. Returns (masked tokens, mask)."""
    t = torch.as_tensor(t, dtype=torch.float32, device=tokens.device)
    while t.ndim < tokens.ndim:
        t = t[..., None]
    m = u < t
    if maskable is not None:
        m = m & maskable
    return torch.where(m, torch.full_like(tokens, mask_id), tokens), m


def confidence_and_candidates(logits, tokens, mask_id: int):
    """Greedy candidate (first-occurrence argmax, as ``jnp.argmax``) and
    its probability per position; unmasked positions get -inf."""
    probs = torch.softmax(logits.float(), dim=-1)
    cand = torch.argmax(logits, dim=-1)
    conf = probs.gather(-1, cand[..., None])[..., 0]
    conf = torch.where(tokens == mask_id, conf, torch.full_like(conf,
                                                                -torch.inf))
    return cand, conf


def confidence_and_candidates_fused(hidden, w, tokens, mask_id: int, *,
                                    softcap=None):
    """:func:`confidence_and_candidates` from pre-``lm_head`` hidden states
    ``(..., d)`` and the ``(V, d)`` unembedding, through the fused
    unembed + select kernel: no ``(..., V)`` logits tensor is built.
    ``softcap`` is the model's final-logit softcap."""
    return fused_select(hidden, w, tokens == mask_id, softcap=softcap)


def select_topk_in_block(conf, block_mask, k: int = 1):
    """Boolean selection of the top-k confident positions within the block."""
    masked_conf = torch.where(block_mask, conf,
                              torch.full_like(conf, -torch.inf))
    if k == 1:
        idx = torch.argmax(masked_conf, dim=-1)
        # a one-hot by comparison: no host check of idx (a CUDA graph
        # captures this)
        sel = idx[..., None] == torch.arange(conf.shape[-1],
                                             device=conf.device)
        # nothing to select once the whole block is finalized
        return sel & torch.isfinite(masked_conf).any(-1, keepdim=True)
    thresh = torch.topk(masked_conf, k, dim=-1).values[..., -1:]
    return (masked_conf >= thresh) & torch.isfinite(masked_conf)


def select_threshold_in_block(conf, block_mask, tau):
    """Every position with conf >= tau, and always the single most
    confident masked one. ``tau``: scalar or per-lane ``(b, 1)``."""
    masked_conf = torch.where(block_mask, conf,
                              torch.full_like(conf, -torch.inf))
    return (masked_conf >= tau) | select_topk_in_block(conf, block_mask, 1)
