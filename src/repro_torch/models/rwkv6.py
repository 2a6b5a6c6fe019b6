"""RWKV6 ("Finch") blocks, attention-free with a data-dependent decay,
ported from the JAX package's ``models/rwkv6.py``.

``time_mix``: static per-channel token-shift lerps (the reference's v5-style
simplification of v6's ddlerp), receptance, key, value and gate
projections, the per-channel decay ``w_t = exp(-exp(w0 + tanh(x_w W_a)
W_b))`` in fp32, the per-head recurrence over ``S`` (hs x hs, fp32) with
the ``u`` bonus on the current token, a per-head group norm, the silu gate
and the output projection. ``channel_mix``: ``sigmoid(x_r W_r) *
(relu(x_k W_k)^2 W_v)``, token-shifted. The carried state, ``{"S": (b, H,
hs, hs) fp32, "tm_shift": (b, d), "cm_shift": (b, d)}``, is the model's
cache: O(1) per lane.

The reference scans chunks under ``jax.checkpoint``; here the recurrence
is a loop over the forward's tokens in plain PyTorch, fp32, four kernels
a token (the outer product ``k v``, ``S + u k v``, its product with
``r``, the decayed update).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

GROUP_NORM_EPS = 64e-5


def n_rwkv_heads(cfg: ModelConfig) -> int:
    return cfg.d_model // cfg.rwkv_head_size


def init_rwkv_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                    device="cpu") -> dict:
    H, hs = n_rwkv_heads(cfg), cfg.rwkv_head_size
    return {"S": torch.zeros((batch, H, hs, hs), dtype=torch.float32,
                             device=device),
            "tm_shift": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                    device=device),
            "cm_shift": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                    device=device)}


def _token_shift(x: torch.Tensor, last: torch.Tensor):
    """x: (b, L, d); last: (b, d) -> the previous token's x (b, L, d) and
    the new ``last`` (b, d)."""
    return torch.cat([last[:, None], x[:, :-1]], dim=1), x[:, -1]


def _lerp(x, prev, mu):
    return x + (prev - x) * mu


def time_mix(params, x: torch.Tensor, cfg: ModelConfig,
             state: dict) -> Tuple[torch.Tensor, dict]:
    """x: (b, L, d) -> (y (b, L, d), {"S", "tm_shift"}) from ``state``."""
    b, L, d = x.shape
    H, hs = n_rwkv_heads(cfg), cfg.rwkv_head_size
    prev, new_shift = _token_shift(x, state["tm_shift"].to(x.dtype))
    r = _lerp(x, prev, params["mu_r"]) @ params["wr"]
    k = _lerp(x, prev, params["mu_k"]) @ params["wk"]
    v = _lerp(x, prev, params["mu_v"]) @ params["wv"]
    g = F.silu(_lerp(x, prev, params["mu_g"]) @ params["wg"])
    xw = _lerp(x, prev, params["mu_w"])
    decay_log = -torch.exp(params["w0"] + (torch.tanh(xw @ params["wa"])
                                           @ params["wb"]).float())
    w = torch.exp(decay_log)                           # (b, L, d) in (0, 1)

    def heads(t):                                      # (b, L, H, hs) fp32
        return t.float().reshape(b, L, H, hs)

    r, k, v, w = heads(r), heads(k), heads(v), heads(w)
    u = params["u"].reshape(H, hs)[..., None]          # (H, hs, 1)
    S = state["S"]
    ys = []
    # the tokens split once: a per-token index's backward would fill and
    # add a zero gradient of the whole (b, L, H, hs) tensor, O(L^2) bytes
    for r_t, k_t, v_t, w_t in zip(*(x.unbind(1) for x in (r, k, v, w))):
        kv = k_t[..., :, None] * v_t[..., None, :]      # (b, H, hs, hs)
        ys.append((r_t[..., None, :] @ torch.addcmul(S, u, kv)).squeeze(-2))
        S = torch.addcmul(kv, w_t[..., :, None], S)
    y = torch.stack(ys, 1)                             # (b, L, H, hs)

    # per-head group norm (population variance, as jnp.var)
    mu = y.mean(-1, keepdim=True)
    var = y.var(-1, keepdim=True, correction=0)
    y = (y - mu) * torch.rsqrt(var + GROUP_NORM_EPS)
    y = y * params["ln_w"] + params["ln_b"]
    y = y.reshape(b, L, d).to(x.dtype) * g
    return y @ params["wo"], {
        "S": S, "tm_shift": new_shift.to(state["tm_shift"].dtype)}


def channel_mix(params, x: torch.Tensor, cfg: ModelConfig,
                state: dict) -> Tuple[torch.Tensor, dict]:
    """x: (b, L, d) -> (y, {"cm_shift"}), token-shifted from
    ``state["cm_shift"]``."""
    prev, new_shift = _token_shift(x, state["cm_shift"].to(x.dtype))
    xk = _lerp(x, prev, params["mu_k"])
    xr = _lerp(x, prev, params["mu_r"])
    r = torch.sigmoid(xr @ params["wr"])
    y = torch.square(F.relu(xk @ params["wk"])) @ params["wv"]
    return r * y, {"cm_shift": new_shift.to(state["cm_shift"].dtype)}
