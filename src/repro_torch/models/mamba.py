"""Mamba selective-SSM block (jamba's Mamba slots), ported from the JAX
package's ``models/mamba.py``.

The block: an input projection to ``(u, z)``, a causal depthwise conv of
``u`` over the carried window of the last ``d_conv - 1`` inputs, silu, the
selective coefficients (``_ssm_coeffs``), the diagonal recurrence
``h_t = a_t h_{t-1} + b_t`` from the carried state, ``y = h C + u D``
gated by ``silu(z)``, and the output projection. The carried state,
``{"conv": (b, d_conv - 1, e), "ssm": (b, e, N) fp32}``, is jamba's cache:
O(1) per lane.

The reference scans chunks with ``lax.associative_scan`` under
``jax.checkpoint`` (the chunking bounds remat memory); here the recurrence
is a loop over the forward's tokens in plain PyTorch, fp32, one fused
multiply-add a token, with every step's ``a`` and ``b`` formed up front as
``(b, L, e, N)`` fp32 tensors (and the states ``h`` stacked the same way
for the contraction with ``C``): three tensors of ``4 b L e N`` bytes
each, 537 MB apiece for 8 lanes of 128 tokens at jamba's full width. The
model stack's ``remat`` recomputes each layer period in the backward.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig


def dt_rank(cfg: ModelConfig) -> int:
    return max(1, math.ceil(cfg.d_model / 16))


def d_inner(cfg: ModelConfig) -> int:
    return cfg.mamba_expand * cfg.d_model


def init_mamba_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device="cpu") -> dict:
    e = d_inner(cfg)
    return {"conv": torch.zeros((batch, cfg.mamba_d_conv - 1, e),
                                dtype=dtype, device=device),
            "ssm": torch.zeros((batch, e, cfg.mamba_d_state),
                               dtype=torch.float32, device=device)}


def _ssm_coeffs(params, u: torch.Tensor, cfg: ModelConfig):
    """From the post-conv activations ``u`` (b, L, e): ``a`` and ``b`` of
    the recurrence (b, L, e, N) and ``C`` (b, L, N), all fp32, and the step
    sizes ``delta`` (b, L, e) fp32."""
    N, r = cfg.mamba_d_state, dt_rank(cfg)
    proj = u @ params["x_proj"]                         # (b, L, r + 2N)
    dt_in, B, C = torch.split(proj, [r, N, N], dim=-1)
    delta = F.softplus(dt_in @ params["dt_proj_w"]
                       + params["dt_proj_b"]).float()
    A = -torch.exp(params["A_log"])                     # (e, N)
    a = torch.exp(delta[..., None] * A)
    b = (delta * u.float())[..., None] * B.float()[:, :, None, :]
    return a, b, C.float(), delta


def _scan(a: torch.Tensor, b: torch.Tensor, h: torch.Tensor):
    """``h_t = a_t h_{t-1} + b_t`` from ``h`` (b, e, N) over the L steps of
    ``a``, ``b`` (b, L, e, N): every state (b, L, e, N) and the last. The
    steps are split once (``unbind``): indexing ``a[:, t]`` per step would
    give each step's backward a zero gradient of the whole (b, L, e, N)
    tensor to fill and add, O(L^2) bytes a layer."""
    hs = []
    for a_t, b_t in zip(torch.unbind(a, 1), torch.unbind(b, 1)):
        h = torch.addcmul(b_t, a_t, h)
        hs.append(h)
    return torch.stack(hs, 1), h


def mamba_forward(params, x: torch.Tensor, cfg: ModelConfig, *,
                  state: Optional[dict] = None
                  ) -> Tuple[torch.Tensor, dict]:
    """x: (b, L, d) -> (y (b, L, d), new state). Causal; ``state`` (default
    zeros, the conv window in x's dtype) carries ``conv`` and ``ssm``."""
    bsz, L, _ = x.shape
    e, dc = d_inner(cfg), cfg.mamba_d_conv
    if state is None:
        state = init_mamba_state(cfg, bsz, dtype=x.dtype, device=x.device)
    u, z = torch.split(x @ params["in_proj"], [e, e], dim=-1)

    # causal depthwise conv over the carried window, summed in the
    # reference's order
    conv_in = torch.cat([state["conv"].to(u.dtype), u], dim=1)
    u_conv = sum(conv_in[:, i:i + L] * params["conv_w"][i]
                 for i in range(dc)) + params["conv_b"]
    u_conv = F.silu(u_conv)
    new_conv = conv_in[:, conv_in.shape[1] - (dc - 1):] if dc > 1 \
        else state["conv"]

    a, b, C, _ = _ssm_coeffs(params, u_conv, cfg)
    hs, h_last = _scan(a, b, state["ssm"])
    y = torch.einsum("blen,bln->ble", hs, C)
    y = y + u_conv.float() * params["D"]
    y = (y * F.silu(z.float())).to(x.dtype)
    return y @ params["out_proj"], {
        "conv": new_conv.to(state["conv"].dtype), "ssm": h_last}
