"""Plain PyTorch versions of ``csrc/elementwise.cu``'s passes: the chains of
``models/layers.py`` ops that each pass fuses, laid out as the kernels read
them and rounded to the input dtype at the same points (the residual sum
before the norm, the bias sum before RoPE, ``act(g)`` before the product),
fp32 in between. On the CPU each equals today's chain of ``layers.py`` ops
bit for bit (``tests/test_torch_elementwise.py``)."""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def add_rmsnorm(x, delta: Optional[torch.Tensor], w, eps: float):
    """(x + delta, RMSNorm of that sum times w); without ``delta`` x is
    returned as it is. x, delta: (..., d); w: (d,)."""
    if delta is not None:
        x = x + delta
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return x, (y * w.float()).to(x.dtype)


def _rotate(x, bias, norm, cos, sin, hd: int, eps: float):
    """x (b, L, n * hd) plus bias, each head RMS-normed by ``norm`` (hd,)
    where given (rounded to x's dtype), rotated per head at (b or 1, L, 1,
    half) angles, rounded to x's dtype."""
    b, L = x.shape[:2]
    if bias is not None:
        x = x + bias
    x = x.reshape(b, L, -1, hd)
    if norm is not None:
        xf = x.float()
        y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
        x = (y * norm.float()).to(x.dtype)
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype).reshape(b, L, -1)


def qkv_rope(q, k, v, bq, bk, bv, positions, *, head_dim: int,
             theta: float, q_norm=None, k_norm=None, eps: float = 1e-6):
    """The q, k and v projections (b, L, n * head_dim) as the matmuls wrote
    them, each plus its bias where given, each head of q and of k
    RMS-normed by ``q_norm`` / ``k_norm`` (head_dim,) where given, q and k
    rotated at ``positions`` ((L,) or (b, L)) with the angles
    ``pos * exp(-i ln(theta) / half)``. Returns (q, k, v) in the same
    layouts."""
    half = head_dim // 2
    freqs = torch.exp(-torch.arange(0, half, dtype=torch.float32,
                                    device=q.device)
                      * (math.log(theta) / half))
    ang = positions.to(torch.float32)[..., None] * freqs
    ang = ang.reshape(-1 if positions.ndim == 2 else 1, positions.shape[-1],
                      1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    return (_rotate(q, bq, q_norm, cos, sin, head_dim, eps),
            _rotate(k, bk, k_norm, cos, sin, head_dim, eps),
            v if bv is None else v + bv)


def gated_act(g, u, kind: str):
    """act(g) * u: silu, or gelu with the tanh approximation (``kind``
    "gelu", as ``layers.act``), act(g) rounded to g's dtype first."""
    if kind == "silu":
        a = F.silu(g)
    elif kind == "gelu":
        a = F.gelu(g, approximate="tanh")
    else:
        raise ValueError(f"gated_act: no gated activation {kind!r}")
    return a * u
