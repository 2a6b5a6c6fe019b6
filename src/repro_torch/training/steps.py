"""Training losses and steps, ported from the JAX package's
``training/steps.py``.

- ``dlm_pretrain_loss``: Eq. 6 masked-denoising SFT of the bidirectional
  teacher.
- ``cdlm_loss``: Alg. 2, the paper's three-objective fine-tune of the
  block-causal student (full fine-tune or LoRA).
- ``ar_loss``: next-token loss on the answer span.

Their cross-entropy terms (the DLM term of Eqs. 6 and 7, the AR loss) run
through the fused cross-entropy kernel on post-norm hidden states
(``kernels.xent.fused_xent``): the values equal the reference's
logits-based losses, without a ``(b, G, V)`` logits tensor. The KL terms
keep full generation-span logits, as the reference does. A model with a
final-logit softcap is refused (the kernel has none, as the JAX one).
``ar_loss`` and ``cdlm_loss`` take an ``xent_fn`` in place of the kernel
(the dry-run passes a plain one on the meta device, where no kernel runs).

Randomness comes in as draws: ``dlm_draws`` makes the masking ratio ``t``
(b,) and the uniforms ``u`` (b, G) from a ``torch.Generator``; the losses
take them as arguments, so tests can hand them the JAX package's draws.
The ``make_*_step`` functions return steps that compute the loss,
backpropagate, apply AdamW and return ``(trainable, opt_state, metrics)``
with the JAX steps' metrics. The training forward uses the plain
attention, as the reference does: the attention kernels have no backward.
"""
from __future__ import annotations

import torch

from repro_torch import tree as T
from repro_torch.configs.base import CDLMConfig, ModelConfig, TrainConfig
from repro_torch.core import diffusion as D
from repro_torch.core import losses as LS
from repro_torch.core import masks
from repro_torch.kernels.xent import fused_xent
from repro_torch.models import forward
from repro_torch.models import layers as L
from repro_torch.models import lora as LoRA
from repro_torch.optim import adamw


def dlm_draws(generator: torch.Generator, b: int, G: int, device):
    """The DLM term's draws: ``t`` ~ U[0.05, 1) (b,), ``u`` ~ U[0, 1)
    (b, G)."""
    return {"t": D.uniform(generator, (b,), device, 0.05, 1.0),
            "u": D.uniform(generator, (b, G), device)}


def _xent_w(params, cfg: ModelConfig, xent_fn=None):
    """The (V, d) unembedding the cross-entropy reads; the fused kernel
    (``xent_fn`` None) refuses a softcapped model."""
    if xent_fn is None and cfg.final_logit_softcap is not None:
        raise ValueError(f"{cfg.name}: the fused cross-entropy has no "
                         "final-logit softcap; a softcapped model's loss "
                         "cannot go through it")
    return L.unembed_w(params["embed"], cfg)


# ---------------------------------------------------------------------------
# Teacher pretrain (Eq. 6)
# ---------------------------------------------------------------------------
def dlm_pretrain_loss(params, batch, draws, *, cfg: ModelConfig,
                      mode: str = masks.BIDIRECTIONAL, block_size: int = 1,
                      remat: bool = False):
    """batch: prompt (b, P), answer (b, G), maskable (b, G) bool; draws:
    :func:`dlm_draws`. Returns (loss, metrics)."""
    prompt, answer = batch["prompt"], batch["answer"]
    P = prompt.shape[1]
    t = draws["t"]
    masked_answer, m = D.mask_tokens_from(draws["u"], answer, t,
                                          cfg.mask_token_id,
                                          batch["maskable"])
    canvas = torch.cat([prompt, masked_answer], dim=1)
    out = forward(params, canvas, cfg=cfg, device=canvas.device, mode=mode,
                  prompt_len=P, block_size=block_size, remat=remat,
                  return_logits=False)
    loss = LS.dlm_loss_from_hidden(out.hidden[:, P:], _xent_w(params, cfg),
                                   answer, m, t)
    total = loss + cfg.router_aux_weight * out.aux_loss
    return total, {"dlm_loss": loss.detach(), "aux": out.aux_loss.detach()}


# ---------------------------------------------------------------------------
# AR training
# ---------------------------------------------------------------------------
def ar_loss(params, batch, *, cfg: ModelConfig, remat: bool = False,
            xent_fn=None):
    """Next-token loss over the answer span (SFT): the causal forward of
    canvas[:, :-1] read at positions P-1 .. P+G-2, whose targets are the
    answer, weighted by ``maskable``. ``xent_fn(h (T, d), w (V, d), y
    (T,)) -> (T,)`` replaces the fused kernel and applies any final-logit
    softcap itself."""
    prompt, answer = batch["prompt"], batch["answer"]
    b, P = prompt.shape
    canvas = torch.cat([prompt, answer], dim=1)
    out = forward(params, canvas[:, :-1], cfg=cfg, device=canvas.device,
                  mode=masks.CAUSAL, remat=remat, return_logits=False)
    h = out.hidden[:, P - 1:]
    G = answer.shape[1]
    nll = (xent_fn or fused_xent)(
        h.reshape(b * G, -1), _xent_w(params, cfg, xent_fn),
        answer.reshape(b * G)).reshape(b, G)
    w = batch["maskable"].float()
    loss = (nll * w).sum() / w.sum().clamp_min(1.0)
    total = loss + cfg.router_aux_weight * out.aux_loss
    return total, {"ar_loss": loss.detach(), "aux": out.aux_loss.detach()}


# ---------------------------------------------------------------------------
# CDLM (Alg. 2): the paper's objective
# ---------------------------------------------------------------------------
def cdlm_loss(trainable, static_params, batch, draws, *, cfg: ModelConfig,
              cdlm: CDLMConfig, teacher_head, use_lora: bool,
              lora_rank: int = 32, lora_alpha: float = 32.0,
              remat: bool = False, student_mode: str = masks.BLOCK_CAUSAL,
              efficient_loss: bool = False, extras=None, xent_fn=None):
    """Eq. 7 total objective.

    trainable: the LoRA adapters (``use_lora``) or the full student params;
    static_params: the base weights under LoRA (ignored otherwise);
    teacher_head: the frozen teacher ``embed`` params, which turn the stored
    hidden buffer into teacher distributions (App. A.1); batch:
    ``trajectory.training_pair``'s output; draws: :func:`dlm_draws` for
    the DLM term. ``efficient_loss`` applies the lm_head to the generation
    span only (the objectives never read prompt logits). ``extras``: the
    batch's request extras, which every forward takes; a prefix
    (internvl2's ``prefix_embeds``) shifts the prompt length and the
    generation span's rows by its length, as in the reference.
    ``xent_fn`` replaces the fused kernel in the DLM term, as in
    :func:`ar_loss`."""
    params = (LoRA.merge(static_params, trainable, lora_alpha, lora_rank)
              if use_lora else trainable)
    extras = extras or {}
    off = (extras["prefix_embeds"].shape[1] if "prefix_embeds" in extras
           else 0)
    P = batch["prompt"].shape[1]
    G = batch["y"].shape[1] - P
    kw = dict(cfg=cfg, device=batch["y"].device, mode=student_mode,
              prompt_len=off + P, block_size=cdlm.block_size, remat=remat,
              **extras)
    if efficient_loss:
        kw["logits_slice"] = (off + P, off + P + G)

    def span(out):
        return out.logits if efficient_loss else out.logits[:, off + P:]

    # (i) student at y; (ii) student at y*, the detached consistency target.
    # Its router's aux loss is not detached in the reference, so with MoE
    # slots y*'s forward keeps its graph and only its logits are detached.
    out_y = forward(params, batch["y"], **kw)
    logits_y = span(out_y)
    with torch.set_grad_enabled(torch.is_grad_enabled() and
                                cfg.n_experts > 0):
        out_ystar = forward(params, batch["y_star"], **kw)
    logits_ystar = span(out_ystar).detach()
    with torch.no_grad():
        # teacher distributions from the hidden buffer, frozen head
        teacher_logits = L.lm_head(teacher_head, batch["teacher_hidden"],
                                   cfg)
    u_mask = batch["u_mask"][:, P:]
    s_mask = batch["s_mask"][:, P:]
    l_distill = LS.distillation_loss(logits_y, teacher_logits, u_mask,
                                     cdlm.kl_direction)
    l_cons = LS.consistency_loss(logits_y, logits_ystar, s_mask,
                                 cdlm.kl_direction)

    # (iii) DLM loss on ground-truth text
    t = draws["t"]
    masked_gt, m = D.mask_tokens_from(draws["u"], batch["gt"], t,
                                      cfg.mask_token_id,
                                      batch.get("gt_maskable"))
    canvas = torch.cat([batch["prompt"], masked_gt], dim=1)
    out_dlm = forward(params, canvas, **dict(kw, logits_slice=None),
                      return_logits=False)
    l_dlm = LS.dlm_loss_from_hidden(out_dlm.hidden[:, off + P:],
                                    _xent_w(params, cfg, xent_fn),
                                    batch["gt"], m, t,
                                    xent_fn=xent_fn or fused_xent)

    total = LS.cdlm_total(l_distill, l_cons, l_dlm, w_distill=cdlm.w_distill,
                          w_cons=cdlm.w_cons, w_dlm=cdlm.w_dlm)
    aux = out_y.aux_loss + out_ystar.aux_loss + out_dlm.aux_loss
    total = total + cfg.router_aux_weight * aux
    return total, {"distill": l_distill.detach(), "cons": l_cons.detach(),
                   "dlm": l_dlm.detach(), "aux": aux.detach()}


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------
def value_and_grad(loss_fn, trainable):
    """((loss, metrics), grads) of ``loss_fn(trainable)`` with respect to
    every leaf of ``trainable``; the leaves require grad only during the
    call."""
    leaves = T.leaves(trainable)
    for x in leaves:
        x.requires_grad_(True)
    try:
        loss, metrics = loss_fn(trainable)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for x in leaves:
            x.requires_grad_(False)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(leaves, grads)]
    return (loss.detach(), metrics), T.unflatten(trainable, grads)


def _step(loss_fn, tcfg: TrainConfig):
    lr_fn = adamw.make_lr_fn(tcfg)

    def step(trainable, opt_state, *args):
        (loss, metrics), grads = value_and_grad(
            lambda p: loss_fn(p, *args), trainable)
        trainable, opt_state, om = adamw.update(grads, opt_state, trainable,
                                                tcfg, lr_fn)
        return trainable, opt_state, {**metrics, **om, "loss": loss}

    return step


def make_dlm_pretrain_step(cfg: ModelConfig, tcfg: TrainConfig,
                           mode: str = masks.BIDIRECTIONAL,
                           block_size: int = 1):
    """``step(params, opt_state, batch, draws)``."""
    return _step(lambda p, batch, draws: dlm_pretrain_loss(
        p, batch, draws, cfg=cfg, mode=mode, block_size=block_size,
        remat=tcfg.remat), tcfg)


def make_ar_step(cfg: ModelConfig, tcfg: TrainConfig):
    """``step(params, opt_state, batch)``."""
    return _step(lambda p, batch: ar_loss(p, batch, cfg=cfg,
                                          remat=tcfg.remat), tcfg)


def make_cdlm_step(cfg: ModelConfig, cdlm: CDLMConfig, tcfg: TrainConfig,
                   student_mode: str = masks.BLOCK_CAUSAL,
                   efficient_loss: bool = False):
    """``step(trainable, opt_state, static_params, teacher_head, batch,
    draws)``."""
    return _step(lambda p, static, head, batch, draws: cdlm_loss(
        p, static, batch, draws, cfg=cfg, cdlm=cdlm, teacher_head=head,
        use_lora=tcfg.use_lora, lora_rank=tcfg.lora_rank,
        lora_alpha=tcfg.lora_alpha, remat=tcfg.remat,
        student_mode=student_mode, efficient_loss=efficient_loss), tcfg)
