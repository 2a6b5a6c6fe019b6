"""Decode attention: the wrappers of the CUDA kernel ``csrc/decode_attn.cu``.

``decode_attention`` computes what the JAX package's
``kernels/decode_attn/ops.py::decode_attention`` computes: the active
block's queries against the cache rows below each lane's ``cache_len``
plus the block's own fresh keys, under one fp32 online softmax,
normalized. ``paged_decode_attention`` does the same over a block-paged
pool read through per-lane page tables (the JAX
``ops.py::paged_decode_attention``). A CPU tensor takes the plain version
(``ref.py``); a CUDA tensor launches the kernel or raises.

The kernel's route is chosen by dtype, and both are kernels: bf16 runs on
the tensor cores (wgmma; each lane's keys in 64-key tiles, a fixed number
of tiles per split, ``ref.split_plan``; the splits' partials, in scratch
allocated with the output, merged in order by a second kernel of the same
call), fp32 on CUDA cores in fp32, since fp32 on the tensor cores would be
TF32. Neither reads ``cache_lens`` on the host.

The tiles per split are resolved on the host, before the launch, by
``kernels/tuning.py`` (``config=`` > the tuned table > the built-in rule)
from the KV heads and the folded rows only, one key for both wrappers, so
the dense and paged kernels split alike.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, tuning
from repro_torch.kernels.decode_attn import ref

_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
             + [ctypes.c_longlong] * 3 + [ctypes.c_float] * 2
             + [ctypes.c_int] * 2 + [ctypes.c_void_p])
_PAGED_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
                   + [ctypes.c_longlong] * 3 + [ctypes.c_float] * 2
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
HEAD_DIMS = (64, 112, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)


def decode_attention(q, k_cache, v_cache, k_blk, v_blk, cache_lens, *,
                     scale: float = 1.0, softcap: Optional[float] = None,
                     window: Optional[int] = None,
                     config: Optional[tuning.KernelConfig] = None
                     ) -> torch.Tensor:
    """q: (b, Bq, Kv, G, hd); k/v_cache: (b, S, Kv, hd), any strides with a
    unit last one (a period slice of the stacked cache); k/v_blk: (b, Bq,
    Kv, hd); cache_lens: (b,) int32. Returns (b, Bq, Kv, G, hd) fp32.
    ``config``: a ``tuning.KernelConfig`` whose ``tiles_per_split`` wins
    over the table's. Refuses inputs that require grad while grad mode is
    on: there is no backward."""
    _build.refuse_grad("decode_attention", q, k_cache, v_cache, k_blk, v_blk)
    if q.device.type == "cpu":
        return ref.decode_attention(q, k_cache, v_cache, k_blk, v_blk,
                                    cache_lens, scale=scale, softcap=softcap,
                                    window=window)
    b, Bq, Kv, G, hd = q.shape
    S = k_cache.shape[1]
    _check("decode_attention", q, k_cache, v_cache, k_blk, v_blk,
           cache_lens, softcap, window)
    if k_cache.shape != (b, S, Kv, hd) or v_cache.shape != k_cache.shape:
        raise ValueError("decode_attention: shapes q "
                         f"{tuple(q.shape)}, cache {tuple(k_cache.shape)} "
                         "do not match")
    out, T, n_splits, scratch = _out_and_scratch(q, S, config)
    if out.numel() == 0:
        return out
    fn = _build.function("decode_attn_forward", _ARGTYPES)
    sb, ss, sk, _ = k_cache.stride()
    rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            k_blk.data_ptr(), v_blk.data_ptr(), cache_lens.data_ptr(),
            out.data_ptr(), scratch, b, Bq, Kv, G, hd, S, T, n_splits, sb,
            ss, sk, scale, 0.0 if softcap is None else softcap,
            0 if window is None else window, int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "decode_attn_forward")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def paged_decode_attention(q, k_pages, v_pages, k_blk, v_blk, page_table,
                           cache_lens, *, scale: float = 1.0,
                           softcap: Optional[float] = None,
                           window: Optional[int] = None,
                           config: Optional[tuning.KernelConfig] = None
                           ) -> torch.Tensor:
    """q: (b, Bq, Kv, G, hd); k/v_pages: (n_pages, page, Kv, hd) pools, any
    strides with a unit last one (a period slice of the stacked pool);
    k/v_blk: (b, Bq, Kv, hd); page_table: (b, n_t) int32, -1 = unallocated;
    cache_lens: (b,) int32, each at most n_t * page. Returns (b, Bq, Kv, G,
    hd) fp32. ``config`` as for :func:`decode_attention`. Refuses inputs
    that require grad while grad mode is on."""
    _build.refuse_grad("paged_decode_attention", q, k_pages, v_pages, k_blk,
                       v_blk)
    if q.device.type == "cpu":
        return ref.paged_decode_attention(
            q, k_pages, v_pages, k_blk, v_blk, page_table, cache_lens,
            scale=scale, softcap=softcap, window=window)
    b, Bq, Kv, G, hd = q.shape
    _check("paged_decode_attention", q, k_pages, v_pages, k_blk, v_blk,
           cache_lens, softcap, window)
    n_pages, page = k_pages.shape[:2]
    if (k_pages.shape != (n_pages, page, Kv, hd)
            or v_pages.shape != k_pages.shape):
        raise ValueError("paged_decode_attention: shapes q "
                         f"{tuple(q.shape)}, pool {tuple(k_pages.shape)} "
                         "do not match")
    if (page_table.device != q.device or page_table.dtype != torch.int32
            or page_table.ndim != 2 or page_table.shape[0] != b
            or not page_table.is_contiguous()):
        raise ValueError("paged_decode_attention: page_table must be a "
                         f"contiguous ({b}, n_t) int32 tensor on {q.device}")
    n_t = page_table.shape[1]
    out, T, n_splits, scratch = _out_and_scratch(q, n_t * page, config)
    if out.numel() == 0:
        return out
    fn = _build.function("paged_decode_attn_forward", _PAGED_ARGTYPES)
    sp, ss, sk, _ = k_pages.stride()
    rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_blk.data_ptr(), v_blk.data_ptr(), page_table.data_ptr(),
            cache_lens.data_ptr(), out.data_ptr(), scratch, b, Bq, Kv, G, hd,
            n_t, page, T, n_splits, sp, ss, sk, scale,
            0.0 if softcap is None else softcap,
            0 if window is None else window, int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "paged_decode_attn_forward")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def _out_and_scratch(q, S: int, config):
    """(out, tiles per split, splits, scratch pointer) for caches of S
    rows, the tiles per split resolved by ``tuning`` from (Kv, Bq G) and
    ``config``. out is (b, Bq, Kv, G, hd) fp32; on the bf16 route it is the
    head of one allocation whose tail is the scratch of the splits' partials,
    acc (n_splits, b, Kv, Bq G, hd) then (m, l): one allocation a call on
    q's stream, no host sync, nothing kept between calls. The fp32 route
    takes no scratch: (out, 0, 0, None)."""
    b, Bq, Kv, G, hd = q.shape
    n_out = b * Bq * Kv * G * hd
    if q.dtype != torch.bfloat16 or n_out == 0:
        return (torch.empty((b, Bq, Kv, G, hd), dtype=torch.float32,
                            device=q.device), 0, 0, None)
    T = tuning.resolve("decode_attn", config=config,
                       backend_name=tuning.backend(q.device), Kv=Kv,
                       rows=Bq * G).tiles_per_split
    T, n_splits = ref.split_plan(Kv, Bq, G, S, T)
    buf = torch.empty(n_out + n_splits * b * Kv * Bq * G * (hd + 2),
                      dtype=torch.float32, device=q.device)
    return (buf[:n_out].view(b, Bq, Kv, G, hd), T, n_splits,
            buf.data_ptr() + 4 * n_out)


def _check(name, q, k_cache, v_cache, k_blk, v_blk, cache_lens, softcap,
           window) -> None:
    """What both kernels refuse: mixed devices or dtypes, a head_dim or
    layout they do not take, non-positive softcap or window."""
    b, Bq, Kv, G, hd = q.shape
    tensors = (q, k_cache, v_cache, k_blk, v_blk)
    if any(t.device != q.device for t in (*tensors, cache_lens)):
        raise ValueError(f"{name}: tensors on different devices")
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {q.device}")
    if q.dtype not in DTYPES or any(t.dtype != q.dtype for t in tensors):
        raise ValueError(f"{name}: q, caches and block k/v must share one "
                         f"dtype of {DTYPES}")
    if (softcap is not None and softcap <= 0) or (window is not None
                                                  and window <= 0):
        raise ValueError(f"{name}: softcap and window must be positive "
                         "when given")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {hd} not in {HEAD_DIMS}")
    if k_blk.shape != (b, Bq, Kv, hd) or v_blk.shape != k_blk.shape:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, block "
                         f"{tuple(k_blk.shape)} do not match")
    if k_cache.stride() != v_cache.stride() or k_cache.stride(-1) != 1:
        raise ValueError(f"{name}: k/v caches need equal strides and a unit "
                         "stride on head_dim")
    if not all(t.is_contiguous() for t in (q, k_blk, v_blk)):
        raise ValueError(f"{name}: q and block k/v must be contiguous")
    if (cache_lens.shape != (b,) or cache_lens.dtype != torch.int32
            or not cache_lens.is_contiguous()):
        raise ValueError(f"{name}: cache_lens must be a contiguous ({b},) "
                         "int32 tensor")
