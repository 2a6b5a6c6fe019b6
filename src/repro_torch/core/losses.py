"""CDLM training objectives (paper §4.2, Eqs. 4–7), ported from the JAX
package's ``core/losses.py``.

- ``distillation_loss``: forward KL(p_teacher || q_student) on the
  positions newly unmasked between y and y* (U_y); the teacher logits are
  detached.
- ``consistency_loss``: forward KL(q_student(y*) || q_student(y)) on the
  positions still masked at y* (S_y); the y* branch is detached.
- ``dlm_loss``: the masked-denoising objective (Eq. 6) with 1/t weighting,
  on logits (as the reference computes it).
- ``dlm_loss_from_hidden``: the same value from post-norm hidden states and
  the ``(V, d)`` unembedding through the fused cross-entropy kernel, so no
  ``(b, G, V)`` logits tensor is built for the DLM term.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.xent import fused_xent


def _masked_mean(per_pos, mask):
    """Mean over selected positions, normalized per example then batched
    (the 1/|U_y| inner average of Eqs. 4–5)."""
    mask = mask.float()
    count = mask.sum(-1)
    per_example = (per_pos * mask).sum(-1) / count.clamp_min(1.0)
    has_any = (count > 0).float()
    return (per_example * has_any).sum() / has_any.sum().clamp_min(1.0)


def forward_kl(p_logits, q_logits):
    """KL(p || q) per position; logits (..., V)."""
    p_logp = torch.log_softmax(p_logits.float(), dim=-1)
    q_logp = torch.log_softmax(q_logits.float(), dim=-1)
    return (p_logp.exp() * (p_logp - q_logp)).sum(-1)


def reverse_kl(p_logits, q_logits):
    return forward_kl(q_logits, p_logits)


def _kl(target, logits, direction: str):
    return (forward_kl(target, logits) if direction == "forward"
            else reverse_kl(target, logits))


def distillation_loss(student_logits, teacher_logits, newly_unmasked,
                      kl_direction: str = "forward"):
    """Eq. 4. ``newly_unmasked``: bool (b, L) = U_y."""
    kl = _kl(teacher_logits.detach(), student_logits, kl_direction)
    return _masked_mean(kl, newly_unmasked)


def consistency_loss(student_logits_y, student_logits_ystar, still_masked,
                     kl_direction: str = "forward"):
    """Eq. 5. The y* branch is the detached target q_{phi^-}."""
    kl = _kl(student_logits_ystar.detach(), student_logits_y, kl_direction)
    return _masked_mean(kl, still_masked)


def _dlm_from_token_nll(nll, targets, masked, t):
    t = torch.as_tensor(t, dtype=torch.float32,
                        device=nll.device).clamp_min(1e-3)
    per_example = (nll * masked.float()).sum(-1) / t
    # normalized by generation length so the scale matches across configs
    return per_example.mean() / targets.shape[-1]


def dlm_loss(logits, targets, masked, t):
    """Eq. 6: -1/t * sum_{i masked} log q(y_i | y_t, x), averaged over the
    batch and divided by the generation length. t: (b,) masking ratio."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    tok_logp = logp.gather(-1, targets.long()[..., None])[..., 0]
    return _dlm_from_token_nll(-tok_logp, targets, masked, t)


def dlm_loss_from_hidden(hidden, w, targets, masked, t, xent_fn=fused_xent):
    """:func:`dlm_loss` of the logits ``hidden @ w.T`` without building
    them: hidden (b, G, d) post-norm states, w the (V, d) unembedding;
    ``xent_fn(hidden (T, d), w, targets (T,)) -> (T,)`` is the per-token
    cross-entropy (the fused kernel's wrapper)."""
    b, G, d = hidden.shape
    nll = xent_fn(hidden.reshape(b * G, d), w,
                  targets.reshape(b * G)).reshape(b, G)
    return _dlm_from_token_nll(nll, targets, masked, t)


def cdlm_total(l_distill, l_cons, l_dlm, *, w_distill, w_cons, w_dlm):
    """Eq. 7."""
    return w_distill * l_distill + w_cons * l_cons + w_dlm * l_dlm
