"""The masking of the forward process (Eq. 6 setup), its token-level
transition and timesteps (Eq. 2), candidate selection (greedy, sampled,
and per lane) and finalization rules (paper §4.3),
ported from the JAX package's ``core/diffusion.py``.

Sampled candidates come from the JAX package's PRNG streams
(:mod:`repro_torch.prng`), so a sampled decode draws the reference's
tokens. As there, the softmax and the scaled logits are fp32."""
from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.kernels.select import fused_select
from repro_torch.models import layers as L


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


def transition_probs(t: float, s: float, is_masked: bool,
                     p_unmask_token: torch.Tensor) -> dict:
    """Token-level q_{s|t} probabilities (Eq. 2), for tests and
    properties: ``{"keep": P(stay as is), "still_masked": ..., "unmask":
    vector}``."""
    if not 0 <= s < t <= 1:
        raise ValueError(f"need 0 <= s < t <= 1, got s={s}, t={t}")
    if not is_masked:
        return {"keep": 1.0, "still_masked": 0.0,
                "unmask": torch.zeros_like(p_unmask_token)}
    return {"keep": 0.0, "still_masked": s / t,
            "unmask": (t - s) / t * p_unmask_token}


def timestep(k: int, n_steps: int) -> float:
    """t_k = 1 - k/N."""
    return 1.0 - k / n_steps


def _divide(logits: torch.Tensor, t) -> torch.Tensor:
    """fp32 ``logits / t`` as an IEEE division: ``t`` a tensor on the
    logits' device (a host scalar would let CUDA multiply by its
    reciprocal, an ulp away from the reference's division)."""
    if not torch.is_tensor(t):    # filled on the device, not copied
        t = torch.full((), t, dtype=torch.float32, device=logits.device)
    return logits.float() / t


def confidence_and_candidates(logits, tokens, mask_id: int,
                              temperature: float = 0.0, key=None, *,
                              draw_shape=None, draw_index=None):
    """Per-position candidate token and confidence from the logits.

    Greedy (temperature 0 or no key): the first-occurrence argmax, as
    ``jnp.argmax``. Sampled: a draw from ``softmax(logits / T)`` with
    ``key`` (``jax.random.categorical``; ``draw_shape`` and ``draw_index``
    place ``logits`` inside a larger draw, see :func:`prng.categorical`).
    The confidence is the candidate's probability under the temperature-1
    distribution; unmasked positions get -inf."""
    probs = torch.softmax(logits.float(), dim=-1)
    if temperature <= 0.0 or key is None:
        cand = torch.argmax(logits, dim=-1)
    else:
        cand = prng.categorical(key, _divide(logits, temperature),
                                shape=draw_shape, index=draw_index)
    conf = probs.gather(-1, cand[..., None])[..., 0]
    conf = torch.where(tokens == mask_id, conf, torch.full_like(conf,
                                                                -torch.inf))
    return cand, conf


def dense_logits(hidden, w, softcap=None) -> torch.Tensor:
    """fp32 logits of hidden states ``(..., d)`` by the ``(V, d)``
    unembedding, then the final softcap: the model's ``lm_head``."""
    return L.softcap(hidden.float() @ w.float().t(), softcap)


def confidence_and_candidates_fused(hidden, w, tokens, mask_id: int,
                                    temperature: float = 0.0, key=None, *,
                                    softcap=None, draw_shape=None,
                                    draw_index=None):
    """:func:`confidence_and_candidates` from pre-``lm_head`` hidden states
    ``(..., d)`` and the ``(V, d)`` unembedding. Greedy selection goes
    through the fused unembed + select kernel: no ``(..., V)`` logits
    tensor is built. Sampled decoding (``temperature > 0`` with a key)
    takes dense fp32 logits (the ``lm_head`` product, then ``softcap``)
    and :func:`confidence_and_candidates`, as the reference does: the draw
    is shaped like the logits."""
    if temperature > 0.0 and key is not None:
        return confidence_and_candidates(dense_logits(hidden, w, softcap),
                                         tokens, mask_id,
                                         temperature, key,
                                         draw_shape=draw_shape,
                                         draw_index=draw_index)
    return fused_select(hidden, w, tokens == mask_id, softcap=softcap)


def split_lane_keys(keys, active):
    """Advance per-lane keys ``(b, 2)``, only for ``active`` (b,) lanes.

    Returns ``(new_keys, subkeys)``: each lane's key split in two, the
    first half its next key where active (an inactive lane keeps its key;
    its subkey is garbage the caller masks out). A lane's stream thus
    depends on its own decode history alone."""
    pairs = prng.split(keys)                          # (b, 2, 2)
    new_keys = torch.where(active[:, None], pairs[:, 0], keys)
    return new_keys, pairs[:, 1]


def confidence_and_candidates_per_lane(logits, tokens, mask_id: int,
                                       temperatures, keys=None):
    """Per-lane :func:`confidence_and_candidates`: ``temperatures`` (b,);
    lanes at ``<= 0`` take the greedy argmax, the others draw from
    ``softmax(logits / T)`` with their own key of ``keys (b, 2)`` (a
    vmapped categorical: a lane's draw depends on its own logits and key
    only). ``keys=None`` draws nothing (an all-greedy batch)."""
    probs = torch.softmax(logits.float(), dim=-1)
    greedy = torch.argmax(logits, dim=-1)
    if keys is None:
        cand = greedy
    else:
        t = torch.clamp_min(temperatures.float(), 1e-6)
        drawn = prng.categorical(keys, _divide(logits, t[:, None, None]))
        cand = torch.where((temperatures > 0.0)[:, None], drawn, greedy)
    conf = probs.gather(-1, cand[..., None])[..., 0]
    conf = torch.where(tokens == mask_id, conf, torch.full_like(conf,
                                                                -torch.inf))
    return cand, conf


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
