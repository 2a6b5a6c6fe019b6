"""Decode attention: the wrapper of the CUDA kernel ``csrc/decode_attn.cu``.

``decode_attention`` computes what the JAX package's
``kernels/decode_attn/ops.py::decode_attention`` computes: the active
block's queries against the cache rows below each lane's ``cache_len``
plus the block's own fresh keys, under one fp32 online softmax,
normalized. A CPU tensor takes the plain version (``ref.py``); a CUDA
tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attn import ref

_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
             + [ctypes.c_longlong] * 3 + [ctypes.c_float] * 2
             + [ctypes.c_int] * 2 + [ctypes.c_void_p])
HEAD_DIMS = (64, 128)
DTYPES = (torch.float32, torch.bfloat16)


def decode_attention(q, k_cache, v_cache, k_blk, v_blk, cache_lens, *,
                     scale: float = 1.0, softcap: Optional[float] = None,
                     window: Optional[int] = None) -> torch.Tensor:
    """q: (b, Bq, Kv, G, hd); k/v_cache: (b, S, Kv, hd), any strides with a
    unit last one (a period slice of the stacked cache); k/v_blk: (b, Bq,
    Kv, hd); cache_lens: (b,) int32. Returns (b, Bq, Kv, G, hd) fp32."""
    if q.device.type == "cpu":
        return ref.decode_attention(q, k_cache, v_cache, k_blk, v_blk,
                                    cache_lens, scale=scale, softcap=softcap,
                                    window=window)
    b, Bq, Kv, G, hd = q.shape
    S = k_cache.shape[1]
    tensors = (q, k_cache, v_cache, k_blk, v_blk)
    if any(t.device != q.device for t in (*tensors, cache_lens)):
        raise ValueError("decode_attention: tensors on different devices")
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for {q.device}")
    if q.dtype not in DTYPES or any(t.dtype != q.dtype for t in tensors):
        raise ValueError("decode_attention: q, caches and block k/v must "
                         f"share one dtype of {DTYPES}")
    if (softcap is not None and softcap <= 0) or (window is not None
                                                  and window <= 0):
        raise ValueError("decode_attention: softcap and window must be "
                         "positive when given")
    if hd not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head_dim {hd} not in "
                         f"{HEAD_DIMS}")
    if (k_cache.shape != (b, S, Kv, hd) or v_cache.shape != k_cache.shape
            or k_blk.shape != (b, Bq, Kv, hd) or v_blk.shape != k_blk.shape):
        raise ValueError("decode_attention: shapes q "
                         f"{tuple(q.shape)}, cache {tuple(k_cache.shape)}, "
                         f"block {tuple(k_blk.shape)} do not match")
    if k_cache.stride() != v_cache.stride() or k_cache.stride(-1) != 1:
        raise ValueError("decode_attention: k/v caches need equal strides "
                         "and a unit stride on head_dim")
    if not all(t.is_contiguous() for t in (q, k_blk, v_blk)):
        raise ValueError("decode_attention: q and block k/v must be "
                         "contiguous")
    if (cache_lens.shape != (b,) or cache_lens.dtype != torch.int32
            or not cache_lens.is_contiguous()):
        raise ValueError("decode_attention: cache_lens must be a "
                         f"contiguous ({b},) int32 tensor")
    out = torch.empty((b, Bq, Kv, G, hd), dtype=torch.float32,
                      device=q.device)
    if out.numel() == 0:
        return out
    fn = _build.function("decode_attn_forward", _ARGTYPES)
    sb, ss, sk, _ = k_cache.stride()
    rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            k_blk.data_ptr(), v_blk.data_ptr(), cache_lens.data_ptr(),
            out.data_ptr(), b, Bq, Kv, G, hd, S, sb, ss, sk, scale,
            0.0 if softcap is None else softcap,
            0 if window is None else window,
            int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "decode_attn_forward")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
