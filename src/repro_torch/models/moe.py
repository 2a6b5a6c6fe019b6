"""Mixture-of-Experts FFN with capacity-based scatter dispatch, ported from
the JAX package's ``models/moe.py``.

Each token's router probabilities (fp32 softmax) pick its top-k experts,
whose gates are renormalised to sum to 1. For each of the k choices a
token's rank within its expert is a cumulative sum over the one-hot
routing matrix (T, E); tokens are scattered into an expert-major buffer
``(E, C, d)`` (rank past the capacity C: the token goes to a drop row and
that choice adds nothing), the experts run as one batched product, and the
outputs are gathered back and summed with their gates in choice order. A
shared expert, where the config has one, runs densely on every token. The
Switch load-balance loss ``E * sum_e f_e P_e`` comes back beside the
output.

Nothing here reads the device on the host: the capacity is a function of
the token count and the config only, ranks and slots are tensor ops, and
the scatter writes into a buffer of a static ``(E g k C + 1, d)`` shape
(g groups of tokens, see ``moe_per_row``). So
a cached decode's forward, with its MoE layers, is captured into the
engines' CUDA graphs like any other. Ties between router probabilities
pick the lower expert index first, as ``jax.lax.top_k`` does (a stable
descending sort).

The k choices share one batched expert product: choice j's tokens occupy
slots ``[j C, (j + 1) C)`` of each expert's ``k C`` rows, so every expert
weight is read once per forward (the reference loops over the k choices,
reading every expert's weights k times); each choice keeps its own
capacity C, so which tokens drop is the reference's.

A config with ``moe_dispatch`` "grouped" (sdar-30b-a3b, whose Qwen3-MoE
layers compute every choice) takes :func:`apply_moe_grouped` instead, in
every forward: the same routing, then the dropless grouped expert product
over the real (token, choice) pairs (``kernels/moe``), with no capacity
and nothing dropped.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.moe import ref as moe_ref
from repro_torch.models.layers import act


def capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Expert capacity of a capacity-dropping forward:
    ``max(ceil(T k cf / E), 4)``."""
    E, k = cfg.n_experts, cfg.experts_per_token
    return max(int(math.ceil(n_tokens * k * cfg.capacity_factor / E)), 4)


def dropless_capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """The cached decode's bounded capacity, 8x the balanced load:
    ``min(T, max(4, ceil(8 T k / E)))``; a small T keeps C = T, where no
    token can drop."""
    E, k = cfg.n_experts, cfg.experts_per_token
    return min(n_tokens, max(4, math.ceil(n_tokens * k * 8.0 / E)))


def route(params, xt: torch.Tensor, cfg: ModelConfig):
    """(probs (T, E) fp32, gates (T, k) renormalised, expert ids (T, k)):
    the router's softmax and its top k, ties to the lower index."""
    probs = torch.softmax(xt.float() @ params["router"].float(), dim=-1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.experts_per_token
    gates, ids = vals[:, :k], ids[:, :k]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gates, ids


def aux_loss(probs: torch.Tensor, ids: torch.Tensor,
             cfg: ModelConfig) -> torch.Tensor:
    """Switch load balance: E * sum_e (share of choices to e) * (mean
    router probability of e)."""
    E = cfg.n_experts
    chosen = torch.zeros_like(probs).scatter_add_(
        1, ids, torch.ones(ids.shape, dtype=probs.dtype, device=ids.device))
    return E * (chosen.mean(0) * probs.mean(0)).sum()


def _shared(params, xt, cfg: ModelConfig) -> torch.Tensor:
    sp = params["shared"]
    g = act(xt @ sp["wi_gate"], cfg.activation)
    return ((g * (xt @ sp["wi_up"])) @ sp["wo"]).float()


def apply_moe(params, x: torch.Tensor, cfg: ModelConfig,
              dropless: bool = False, *, moe_per_row: bool
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (b, L, d) -> (out (b, L, d) in x's dtype, aux loss fp32 scalar).

    ``dropless`` sizes the buffers by :func:`dropless_capacity` (the cached
    decode's), else by :func:`capacity`. The tokens of the whole batch share
    each expert's capacity, unless ``moe_per_row``: then each row of x is a
    group of its own, with a capacity of its L tokens and ranks counted
    within it, as the reference's one-lane forward vmapped over lanes
    (``core/block_loop.py::lane_block_forward``) computes it; no row's
    tokens then take another row's places. The aux loss is the whole
    batch's either way (the reference discards the one-lane forwards')."""
    b, L, d = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    T = b * L
    n, Tg = (b, L) if moe_per_row else (1, T)       # groups, tokens a group
    C = dropless_capacity(Tg, cfg) if dropless else capacity(Tg, cfg)
    R = n * K * C                               # rows of one expert
    xt = x.reshape(T, d)
    probs, gates, ids = route(params, xt, cfg)
    aux = aux_loss(probs, ids, cfg)

    # choice j of token t of group g goes to row e R + g K C + j C + rank,
    # rank = its place among group g's choice-j tokens of expert e, in
    # token order; past the capacity: the drop row E R
    dev = x.device
    onehot = (ids[..., None] == torch.arange(E, device=dev)).long()
    onehot = onehot.view(n, Tg, K, E)
    rank = ((onehot.cumsum(1) * onehot).sum(-1) - 1).view(T, K)
    keep = rank < C
    group = torch.arange(T, device=dev)[:, None] // Tg
    slot = (ids * R + group * (K * C) + torch.arange(K, device=dev) * C
            + rank)
    slot = torch.where(keep, slot, torch.full_like(slot, E * R))
    buf = x.new_zeros((E * R + 1, d))
    buf.index_put_((slot.t().reshape(-1),),
                   xt.repeat(K, 1))                         # choice-major
    h = buf[:E * R].view(E, R, d)
    g = act(torch.bmm(h, params["wi_gate"]), cfg.activation)
    y = torch.bmm(g * torch.bmm(h, params["wi_up"]), params["wo"])
    y = y.reshape(E * R, d)

    out = torch.zeros((T, d), dtype=torch.float32, device=dev)
    for j in range(K):
        got = y[slot[:, j].clamp_max(E * R - 1)]
        got = torch.where(keep[:, j, None], got, torch.zeros_like(got))
        out = out + got.float() * gates[:, j, None]
    if "shared" in params:
        out = out + _shared(params, xt, cfg)
    return out.reshape(b, L, d).to(x.dtype), aux


def apply_moe_grouped(params, x: torch.Tensor, cfg: ModelConfig,
                      experts_fn=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (b, L, d) -> (out (b, L, d) in x's dtype, aux loss fp32 scalar):
    every token's top-k choices computed, each weighted by its gate and
    summed in choice order (the routing of :func:`route`). The experts run
    through ``experts_fn`` (``kernels.moe.grouped_experts``-shaped; None:
    its plain version, ``kernels/moe/ref.py``). Nothing depends on the
    batch's grouping of tokens: ``apply_moe``'s capacity arguments have no
    counterpart here."""
    if "shared" in params:
        raise ValueError(f"{cfg.name}: the grouped dispatch has no shared "
                         "expert")
    b, L, d = x.shape
    xt = x.reshape(b * L, d)
    probs, gates, ids = route(params, xt, cfg)
    fn = moe_ref.grouped_experts if experts_fn is None else experts_fn
    out = fn(xt, gates, ids, params["wi_gate"], params["wi_up"],
             params["wo"])
    return out.reshape(b, L, d), aux_loss(probs, ids, cfg)


def apply_moe_dense_fallback(params, x: torch.Tensor,
                             cfg: ModelConfig) -> torch.Tensor:
    """Every expert on every token, weighted by the gates (tests only)."""
    b, L, d = x.shape
    xt = x.reshape(-1, d)
    _, gates, ids = route(params, xt, cfg)
    g = act(torch.einsum("td,edf->tef", xt, params["wi_gate"]),
            cfg.activation)
    u = torch.einsum("td,edf->tef", xt, params["wi_up"])
    y = torch.einsum("tef,efd->ted", g * u, params["wo"])
    w = torch.zeros((xt.shape[0], cfg.n_experts), dtype=torch.float32,
                    device=x.device).scatter_add_(1, ids, gates)
    out = torch.einsum("te,ted->td", w, y.float())
    if "shared" in params:
        out = out + _shared(params, xt, cfg)
    return out.reshape(b, L, d).to(x.dtype)
