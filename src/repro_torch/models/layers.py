"""Functional layers of the decoder stack, ported from the JAX package's
``models/layers.py``.

Conventions (the JAX package's, kept so that tests compare like with like):

- Params are plain nested dicts of tensors; weights are ``(in, out)`` so a
  projection is ``x @ w``. One exception: an untied unembedding is stored
  ``(V, d)`` like the token embedding, so ``unembed_w`` is ``(V, d)`` for
  tied and untied heads alike and the fused select kernel reads rows.
- Attention tensors use the grouped-query layout
  q: ``(b, Lq, Kv, G, hd)``; k/v: ``(b, Lk, Kv, hd)``.
- Attention logits and softmax are fp32 whatever the param dtype.
- Visibility is ``bias_fn(q_pos, kv_pos, kv_valid) -> (Lq, Lk)`` or, with
  per-lane positions, ``(b, Lq, Lk)`` additive fp32 bias.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig


def apply_norm(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """RMSNorm, or layernorm with a bias (``cfg.norm_type``), in fp32, cast
    back to the input dtype. Layernorm's variance is the population one
    (``jnp.var``; torch's default divides by n - 1)."""
    xf = x.float()
    if cfg.norm_type == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, correction=0)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        return (y * params["w"].float() + params["b"].float()).to(x.dtype)
    if cfg.norm_type != "rmsnorm":
        raise ValueError(f"norm {cfg.norm_type!r} is not ported")
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + cfg.norm_eps)
    return (y * params["w"].float()).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (b, L, heads..., hd); positions: (L,) or (b, L)."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device)
                      * (math.log(theta) / half))
    ang = positions.to(torch.float32)[..., None] * freqs   # (..., L, half)
    while ang.ndim < x.ndim - 2 + positions.ndim:   # heads axes after L
        ang = ang[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_embedding(positions: torch.Tensor, d_model: int,
                         device=None) -> torch.Tensor:
    """Whisper's position table at ``positions`` (any shape): fp32
    ``[sin, cos]`` of ``pos * exp(-i ln(10000) / max(d/2 - 1, 1))``,
    ``(..., d_model)``."""
    half = d_model // 2
    positions = torch.as_tensor(positions, device=device)
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32,
                                    device=positions.device)
                      * (math.log(10_000.0) / max(half - 1, 1)))
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    return x if cap is None else cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------
def project_q(params, x, cfg: ModelConfig):
    b, L, _ = x.shape
    q = x @ params["wq"]
    if "bq" in params:
        q = q + params["bq"]
    return q.reshape(b, L, cfg.n_kv_heads, cfg.q_per_kv, cfg.head_dim)


def project_kv(params, x, cfg: ModelConfig):
    b, L, _ = x.shape
    k = x @ params["wk"]
    v = x @ params["wv"]
    if "bk" in params:
        k = k + params["bk"]
        v = v + params["bv"]
    return (k.reshape(b, L, cfg.n_kv_heads, cfg.head_dim),
            v.reshape(b, L, cfg.n_kv_heads, cfg.head_dim))


def head_norm(x, w, eps: float):
    """RMSNorm of each head's ``hd`` values (the last axis) times ``w``
    (hd,), in fp32, cast back: the QK-norm of q and of k before RoPE."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (y * w.float()).to(x.dtype)


def out_proj(params, attn_out, cfg: ModelConfig):
    b, L = attn_out.shape[:2]
    return attn_out.reshape(b, L, cfg.n_heads * cfg.head_dim) @ params["wo"]


def attn_scale(cfg: ModelConfig) -> float:
    if cfg.query_pre_attn_scalar is not None:
        return 1.0 / math.sqrt(cfg.query_pre_attn_scalar)
    return 1.0 / math.sqrt(cfg.head_dim)


BiasFn = Callable[..., torch.Tensor]


def _lift_bias(bias: torch.Tensor) -> torch.Tensor:
    """(Lq, Lk) or (b, Lq, Lk) bias -> broadcastable to (b, Kv, G, Lq, Lk)."""
    return bias[:, None, None] if bias.ndim == 3 else bias[None, None, None]


def _dense_attention(q, k, v, *, q_pos, kv_pos, kv_valid, bias_fn: BiasFn,
                     scale: float, cap: Optional[float]):
    scores = torch.einsum("bqkgh,bskh->bkgqs", q.float(), k.float()) * scale
    scores = softcap(scores, cap)
    scores = scores + _lift_bias(bias_fn(q_pos, kv_pos, kv_valid))
    p = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bkgqs,bskh->bqkgh", p, v)


def _chunked_attention(q, k, v, *, q_pos, kv_pos, kv_valid, bias_fn: BiasFn,
                       scale: float, cap: Optional[float], chunk: int,
                       q_chunk: int = 1024):
    """Online-softmax attention: a loop over query chunks times a loop over
    KV chunks, so live score memory is O(q_chunk x chunk)."""
    b, Lq, Kv, G, hd = q.shape
    if Lq > q_chunk and Lq % q_chunk == 0:
        outs = [_chunked_attention(q[:, j:j + q_chunk], k, v,
                                   q_pos=q_pos[..., j:j + q_chunk],
                                   kv_pos=kv_pos, kv_valid=kv_valid,
                                   bias_fn=bias_fn, scale=scale, cap=cap,
                                   chunk=chunk, q_chunk=q_chunk)
                for j in range(0, Lq, q_chunk)]
        return torch.cat(outs, dim=1)
    Lk = k.shape[1]
    if kv_valid is None:
        kv_valid = torch.ones((Lk,), dtype=torch.bool, device=k.device)
    qf = q.float() * scale
    m = torch.full((b, Kv, G, Lq), -math.inf, device=q.device)
    l = torch.zeros((b, Kv, G, Lq), device=q.device)
    acc = torch.zeros((b, Lq, Kv, G, hd), device=q.device)
    for j in range(0, Lk, chunk):
        kj, vj = k[:, j:j + chunk].float(), v[:, j:j + chunk].float()
        s = torch.einsum("bqkgh,bskh->bkgqs", qf, kj)
        s = softcap(s, cap)
        s = s + _lift_bias(bias_fn(q_pos, kv_pos[..., j:j + chunk],
                                   kv_valid[..., j:j + chunk]))
        mj = torch.maximum(m, s.amax(-1))
        # fully-masked rows: exp(-inf - -inf) -> use a finite floor
        mj_safe = torch.where(torch.isfinite(mj), mj, torch.zeros_like(mj))
        p = torch.exp(s - mj_safe[..., None])
        alpha = torch.where(torch.isfinite(m), torch.exp(m - mj_safe),
                            torch.zeros_like(m))
        l = l * alpha + p.sum(-1)
        acc = acc * alpha.permute(0, 3, 1, 2)[..., None]
        acc = acc + torch.einsum("bkgqs,bskh->bqkgh", p, vj)
        m = mj
    out = acc / l.clamp_min(1e-30).permute(0, 3, 1, 2)[..., None]
    return out.to(v.dtype)


def cross_attention(q, ck, cv, *, scale: float):
    """Decoder queries against every encoder row (whisper's cross
    attention), as the reference's dense attention with a zero bias:
    fp32 scores and softmax, the weights cast to ``cv``'s dtype.

    q: (b, Lq, Kv, G, hd); ck/cv: (b, enc_len, Kv, hd)."""
    scores = torch.einsum("bqkgh,bskh->bkgqs", q.float(), ck.float()) * scale
    p = torch.softmax(scores, dim=-1).to(cv.dtype)
    return torch.einsum("bkgqs,bskh->bqkgh", p, cv)


def attention_core(q, k, v, *, q_pos, kv_pos, kv_valid=None, bias_fn: BiasFn,
                   scale: float, cap: Optional[float] = None,
                   impl: str = "auto", chunk: int = 2048):
    """Grouped-query attention with pluggable visibility.

    q: (b, Lq, Kv, G, hd); k/v: (b, Lk, Kv, hd) -> (b, Lq, Kv, G, hd)
    """
    Lk = k.shape[1]
    if impl == "auto":
        impl = "chunked" if Lk >= 4096 else "dense"
    if impl == "dense":
        if kv_valid is None:
            kv_valid = torch.ones((Lk,), dtype=torch.bool, device=k.device)
        return _dense_attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos,
                                kv_valid=kv_valid, bias_fn=bias_fn,
                                scale=scale, cap=cap)
    if impl == "chunked":
        return _chunked_attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos,
                                  kv_valid=kv_valid, bias_fn=bias_fn,
                                  scale=scale, cap=cap, chunk=chunk)
    raise ValueError(f"unknown attention impl {impl!r}")


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------
def act(x, kind: str):
    """The FFN's activation: silu (SwiGLU), gelu (GeGLU) or gelu_plain
    (whisper's non-gated MLP). JAX's ``jax.nn.gelu`` defaults to the tanh
    approximation, so both gelus are ``approximate="tanh"`` here, not
    torch's exact default."""
    if kind == "silu":
        return F.silu(x)
    if kind in ("gelu", "gelu_plain"):
        return F.gelu(x, approximate="tanh")
    raise ValueError(f"activation {kind!r} is not ported")


def apply_mlp(params, x, cfg: ModelConfig):
    """The gated FFN, act(x W_gate) * (x W_up), then W_out; or, where the
    params hold ``wi`` (whisper), the plain one, act(x W_in) W_out."""
    if "wi" in params:
        return act(x @ params["wi"], cfg.activation) @ params["wo"]
    g = act(x @ params["wi_gate"], cfg.activation)
    return (g * (x @ params["wi_up"])) @ params["wo"]


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------
def embed_tokens(params, tokens, cfg: ModelConfig):
    """The token embeddings, times sqrt(d_model) where ``embed_scale`` says
    so. The scale is first rounded to the embeddings' dtype, as the
    reference does (``jnp.asarray(sqrt(d), x.dtype)``): in bf16 gemma-7b's
    sqrt(3072) = 55.43 becomes 55.5, and a product with the unrounded scale
    (rounded once, in fp32) differs from the reference's in about a fifth
    of the entries."""
    x = params["tok"][tokens]
    if cfg.embed_scale:
        # rounded on the host: no copy to the device inside a graph
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype).item()
    return x


def unembed_w(params, cfg: ModelConfig) -> torch.Tensor:
    """The (V, d) unembedding: the token embedding itself when tied, else
    the head, which the port stores (V, d) as well."""
    return params["tok"] if cfg.tie_embeddings else params["head"]


def lm_head(params, x, cfg: ModelConfig):
    """fp32 logits (..., V)."""
    logits = x.float() @ unembed_w(params, cfg).float().t()
    return softcap(logits, cfg.final_logit_softcap)
