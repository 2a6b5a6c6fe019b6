"""The forward's fused elementwise passes: the wrappers of
``csrc/elementwise.cu``.

``add_rmsnorm`` (residual add + RMSNorm), ``qkv_rope`` (QKV bias, the
QK-norm where the config has one, and RoPE)
and ``gated_act`` (act(g) * u) each compute one chain of
``models/layers.py`` ops in one pass. A CPU tensor takes the plain version
(``ref.py``); a CUDA tensor launches the kernel or raises. The kernels take
bf16 only (the plain path covers everything else) and have no backward, so
the forward calls them only where no gradient is carried, and each wrapper
refuses an input that requires grad in grad mode. Each wrapper allocates its
outputs and counts its launches in ``.launches``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.elementwise import ref

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_NORM_ARGTYPES = [_P] * 5 + [_I64, ctypes.c_int, ctypes.c_float,
                             ctypes.c_float, _P]
_ROPE_ARGTYPES = ([_P] * 7 + [_I64, _I64, _I64, ctypes.c_int] + [_P] * 3
                  + [ctypes.c_int] * 3 + [ctypes.c_float] + [_P] * 2
                  + [ctypes.c_float] * 3 + [_P])
_ACT_ARGTYPES = [_P] * 3 + [_I64, ctypes.c_int, _P]
MAX_D = 8192          # add_rmsnorm_kernel: 256 threads x 4 vectors of 8
HEAD_DIMS = (64, 112, 128, 256)
# the QK-norm's head reduction runs over the head's 8-wide chunks, a power
# of two of lanes of one warp
QK_NORM_HEAD_DIMS = (64, 128, 256)
ACTS = {"silu": 0, "gelu": 1}


def _check(name, *tensors, device):
    for t in tensors:
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{name}: tensors on different devices")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name}: the kernel takes bf16, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be contiguous and "
                             "16-byte aligned (8-element vector loads)")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def add_rmsnorm(x, delta: Optional[torch.Tensor], w, eps: float):
    """x, delta: (..., d); w: (d,) -> (x + delta, its RMSNorm times w), the
    sum rounded to x's dtype before the norm; without ``delta`` the norm of
    x (x returned as it is)."""
    _build.refuse_grad("add_rmsnorm", x, w,
                       *(() if delta is None else (delta,)))
    if x.device.type == "cpu":
        return ref.add_rmsnorm(x, delta, w, eps)
    d = x.shape[-1]
    _check("add_rmsnorm", x, delta, w, device=x.device)
    if delta is not None and delta.shape != x.shape:
        raise ValueError(f"add_rmsnorm: x {tuple(x.shape)} and delta "
                         f"{tuple(delta.shape)} differ")
    if w.shape != (d,) or d % 8 or d > MAX_D:
        raise ValueError(f"add_rmsnorm: d {d} (a multiple of 8 up to "
                         f"{MAX_D}) and w {tuple(w.shape)} do not fit")
    rows = x.numel() // d
    h = torch.empty_like(x)
    x_out = x if delta is None else torch.empty_like(x)
    # PyTorch's mean: the sum times rows / (rows * d), in fp32
    inv_d = float(np.float32(rows) / np.float32(rows * d)) if rows else 0.0
    fn = _build.function("ew_add_rmsnorm", _NORM_ARGTYPES)
    rc = fn(x.data_ptr(), None if delta is None else delta.data_ptr(),
            w.data_ptr(), x_out.data_ptr(), h.data_ptr(), rows, d, inv_d,
            eps, _stream(x.device))
    _build.check(rc, "ew_add_rmsnorm")
    add_rmsnorm.launches += 1
    return x_out, h


def qkv_rope(q, k, v, bq, bk, bv, positions, *, head_dim: int,
             theta: float, q_norm=None, k_norm=None, eps: float = 1e-6):
    """q (b, L, n_q * head_dim), k and v (b, L, n_kv * head_dim), the
    projections as the matmuls wrote them; biases (n * head_dim,) or None;
    positions (L,) or (b, L) ints -> (q, k, v): each plus its bias, each
    head of q and k RMS-normed (``eps``) by ``q_norm`` / ``k_norm``
    (head_dim,) where given (both or neither), q and k rotated at the
    positions. Without ``bv``, v is returned as it is."""
    ins = (q, k, v, bq, bk, bv, q_norm, k_norm)
    _build.refuse_grad("qkv_rope", *(t for t in ins if t is not None))
    if q.device.type == "cpu":
        return ref.qkv_rope(q, k, v, bq, bk, bv, positions,
                            head_dim=head_dim, theta=theta, q_norm=q_norm,
                            k_norm=k_norm, eps=eps)
    _check("qkv_rope", *ins, device=q.device)
    b, L = q.shape[:2]
    hd = head_dim
    n_q, n_kv = q.shape[-1] // hd, k.shape[-1] // hd
    qkn = q_norm is not None
    if (qkn != (k_norm is not None)
            or (qkn and (hd not in QK_NORM_HEAD_DIMS
                         or q_norm.shape != (hd,) or k_norm.shape != (hd,)))):
        raise ValueError(f"qkv_rope: q_norm and k_norm ({hd},) together, at "
                         f"head_dim one of {QK_NORM_HEAD_DIMS}")
    if (hd not in HEAD_DIMS or q.ndim != 3 or q.shape[-1] != n_q * hd
            or k.shape != (b, L, n_kv * hd) or v.shape != k.shape
            or (bq is not None and bq.shape != (n_q * hd,))
            or (bk is not None and bk.shape != (n_kv * hd,))
            or (bv is not None and bv.shape != (n_kv * hd,))):
        raise ValueError(f"qkv_rope: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} at head_dim {hd} (one of "
                         f"{HEAD_DIMS}) do not fit")
    if positions.device != q.device or positions.shape[-1] != L:
        raise ValueError(f"qkv_rope: positions {tuple(positions.shape)} on "
                         f"{positions.device} do not fit L {L}")
    pos = positions.to(torch.int64).expand(b, L)
    q_out, k_out = torch.empty_like(q), torch.empty_like(k)
    v_out = v if bv is None else torch.empty_like(v)
    log_step = float(np.float32(math.log(theta) / (hd // 2)))
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    # PyTorch's mean over each head of (b, L, n, hd): the sum times
    # rows / (rows * hd), in fp32
    inv_q, inv_k = (float(np.float32(r) / np.float32(r * hd)) if r else 0.0
                    for r in (b * L * n_q, b * L * n_kv))
    fn = _build.function("ew_qkv_rope", _ROPE_ARGTYPES)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(bq), ptr(bk),
            ptr(bv), pos.data_ptr(), pos.stride(0), pos.stride(1), b * L, L,
            q_out.data_ptr(), k_out.data_ptr(), v_out.data_ptr(), n_q, n_kv,
            hd, log_step, ptr(q_norm), ptr(k_norm), inv_q, inv_k, eps,
            _stream(q.device))
    _build.check(rc, "ew_qkv_rope")
    qkv_rope.launches += 1
    return q_out, k_out, v_out


def gated_act(g, u, kind: str):
    """act(g) * u for ``kind`` "silu" or "gelu" (tanh approximation), act(g)
    rounded to g's dtype before the product; g, u of one shape."""
    _build.refuse_grad("gated_act", g, u)
    if g.device.type == "cpu":
        return ref.gated_act(g, u, kind)
    _check("gated_act", g, u, device=g.device)
    if kind not in ACTS or u.shape != g.shape or g.numel() % 8:
        raise ValueError(f"gated_act: {kind!r} (one of {tuple(ACTS)}) on g "
                         f"{tuple(g.shape)} and u {tuple(u.shape)} (a "
                         "multiple of 8 elements)")
    out = torch.empty_like(g)
    fn = _build.function("ew_gated_act", _ACT_ARGTYPES)
    rc = fn(g.data_ptr(), u.data_ptr(), out.data_ptr(), g.numel(),
            ACTS[kind], _stream(g.device))
    _build.check(rc, "ew_gated_act")
    gated_act.launches += 1
    return out


add_rmsnorm.launches = 0
qkv_rope.launches = 0
gated_act.launches = 0
