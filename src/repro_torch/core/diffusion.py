"""Greedy candidate selection and finalization rules (paper §4.3), ported
from the JAX package's ``core/diffusion.py``. Greedy only: sampled
decoding is not ported yet."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.select import fused_select


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
        sel = F.one_hot(idx, conf.shape[-1]).bool()
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
