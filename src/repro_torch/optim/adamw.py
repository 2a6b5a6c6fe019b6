"""AdamW with global-norm clipping and decay masking, ported from the JAX
package's ``optim/adamw.py``. Moments are fp32 trees mirroring the params;
the update is computed in fp32 and cast to each param's dtype. Unlike the
JAX version, ``update`` writes the new params and moments into the given
tensors (no second copy of a model's weights and moments) and returns
them."""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch import tree as T
from repro_torch.configs.base import TrainConfig


class AdamWState(NamedTuple):
    step: int
    m: Any
    v: Any


def init(params) -> AdamWState:
    zeros = T.tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                       params)
    return AdamWState(step=0, m=zeros, v=T.tree_map(torch.clone, zeros))


def _global_norm(tree):
    return torch.sqrt(sum(x.float().square().sum() for x in T.leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    """(fp32 grads scaled to a global norm of at most ``max_norm``, norm)."""
    norm = _global_norm(grads)
    scale = (max_norm / norm.clamp_min(1e-9)).clamp_max(1.0)
    return T.tree_map(lambda g: g.float() * scale, grads), norm


def decay_path(path) -> str:
    """The path string the JAX ``_no_decay`` tests: dict keys joined by
    "/", a tuple index spelled "" (``getattr(p, "key", getattr(p, "name",
    ""))`` of a ``SequenceKey``), so ``("slots", 0, "attn", "wq")`` is
    ``"slots//attn/wq"``."""
    return "/".join(k if isinstance(k, str) else "" for k in path)


def _no_decay(path) -> bool:
    """Norm scales / biases / 1-d params are meant to be exempt from weight
    decay. The test is the JAX package's substring match, kept decision for
    decision: its "b" and "u" also exempt ``embed/tok`` and ``mlp/wi_up``
    (a fault of the reference, ROADMAP Queue 3)."""
    flat = decay_path(path)
    return any(s in flat for s in ("norm", "ln_", "mu_", "b", "bias", "w0",
                                   "u", "D"))


def warmup_constant_lr(cfg: TrainConfig) -> Callable[[int], float]:
    warm = max(int(cfg.steps * cfg.warmup_frac), 1)

    def lr(step: int) -> float:
        return cfg.learning_rate * min(step / warm, 1.0)

    return lr


def warmup_cosine_lr(cfg: TrainConfig, final_frac: float = 0.05):
    warm = max(int(cfg.steps * cfg.warmup_frac), 1)
    total = max(cfg.steps, warm + 1)

    def lr(step: int) -> float:
        wfrac = min(step / warm, 1.0)
        prog = min(max((step - warm) / (total - warm), 0.0), 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + math.cos(math.pi
                                                                  * prog))
        return cfg.learning_rate * wfrac * cos

    return lr


def make_lr_fn(cfg: TrainConfig):
    return (warmup_cosine_lr(cfg) if cfg.lr_schedule == "cosine"
            else warmup_constant_lr(cfg))


def update(grads, state: AdamWState, params, cfg: TrainConfig,
           lr_fn: Optional[Callable] = None):
    """One AdamW step. Returns (params, state, {"grad_norm", "lr"}), the
    params and moments updated in place."""
    lr_fn = lr_fn or warmup_constant_lr(cfg)
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = state.step + 1
    lr = lr_fn(step)
    b1, b2, eps = cfg.b1, cfg.b2, cfg.eps
    bc1 = 1.0 - b1 ** step
    bc2 = 1.0 - b2 ** step

    def upd(path, p, g, m, v):
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        pf = p.float()
        if cfg.weight_decay and not _no_decay(path):
            delta = delta + cfg.weight_decay * pf
        p.copy_(pf - lr * delta)

    with torch.no_grad():
        T.map_with_path(upd, params, grads, state.m, state.v)
    return params, AdamWState(step, state.m, state.v), {"grad_norm": gnorm,
                                                        "lr": lr}
