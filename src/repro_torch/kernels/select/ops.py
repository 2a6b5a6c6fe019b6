"""Fused unembed + greedy select: the wrapper of ``csrc/select.cu``.

``fused_select`` maps hidden states ``(..., d)`` and the ``(V, d)``
unembedding to the argmax token of each row's softmax and its probability,
without a ``(..., V)`` logits tensor, as the JAX package's
``kernels/select/ops.py::fused_select`` does. A CPU tensor takes the plain
online version (``ref.select_streaming``); a CUDA tensor launches the
kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.select import ref

_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_float]
             + [ctypes.c_int] + [ctypes.c_void_p])
DTYPES = (torch.float32, torch.bfloat16)
ROW_TILE = 64     # hidden rows per block (BM in select.cu)
VOCAB_TILE = 64   # vocab rows per inner tile (BN in select.cu)
BLOCKS_PER_SM = 4  # resident blocks per SM the vocab split aims for


def fused_select(hidden, w, masked, *, softcap: Optional[float] = None):
    """hidden: (..., d); w: (V, d); masked: (...) bool (False = finalized
    row) -> (cand (...) int32, conf (...) fp32). Refuses inputs that
    require grad while grad mode is on: there is no backward."""
    _build.refuse_grad("fused_select", hidden, w)
    lead = hidden.shape[:-1]
    h2 = hidden.reshape(-1, hidden.shape[-1])
    m2 = masked.reshape(-1)
    if h2.device.type == "cpu":
        cand, conf = ref.select_streaming(h2, w, m2, softcap=softcap)
    else:
        cand, conf = _launch(h2, w, m2, softcap)
    return cand.reshape(lead), conf.reshape(lead)


def _launch(h, w, masked, softcap):
    T, d = h.shape
    V = w.shape[0]
    if w.device != h.device or masked.device != h.device:
        raise ValueError("fused_select: tensors on different devices")
    if h.device.type != "cuda":
        raise ValueError(f"fused_select: no kernel for {h.device}")
    if h.dtype not in DTYPES or w.dtype != h.dtype:
        raise ValueError("fused_select: hidden and w must share one dtype "
                         f"of {DTYPES}")
    if w.ndim != 2 or w.shape[1] != d or V == 0 or masked.shape != (T,):
        raise ValueError(f"fused_select: hidden {tuple(h.shape)}, w "
                         f"{tuple(w.shape)} (V, d) and mask "
                         f"{tuple(masked.shape)} do not match")
    if not (h.is_contiguous() and w.is_contiguous()):
        raise ValueError("fused_select: hidden and w must be contiguous")
    if d % 8 or h.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("fused_select: d must be a multiple of 8 and the "
                         "buffers 16-byte aligned (8-element vector loads)")
    if softcap is not None and softcap <= 0:
        raise ValueError("fused_select: softcap must be positive")
    cand = torch.empty((T,), dtype=torch.int32, device=h.device)
    conf = torch.empty((T,), dtype=torch.float32, device=h.device)
    if T == 0:
        return cand, conf
    n_sms = torch.cuda.get_device_properties(h.device).multi_processor_count
    per_chunk, n_chunks = _build.chunking(T, V, n_sms, ROW_TILE, VOCAB_TILE,
                                          BLOCKS_PER_SM)
    part_m = torch.empty((n_chunks, T), dtype=torch.float32, device=h.device)
    part_l = torch.empty_like(part_m)
    part_i = torch.empty((n_chunks, T), dtype=torch.int32, device=h.device)
    mask_i32 = masked.to(torch.int32)
    fn = _build.function("select_forward", _ARGTYPES)
    rc = fn(h.data_ptr(), w.data_ptr(), mask_i32.data_ptr(), cand.data_ptr(),
            conf.data_ptr(), part_m.data_ptr(), part_l.data_ptr(),
            part_i.data_ptr(), T, V, d, per_chunk, n_chunks,
            0.0 if softcap is None else softcap,
            int(h.dtype == torch.bfloat16),
            torch.cuda.current_stream(h.device).cuda_stream)
    _build.check(rc, "select_forward")
    fused_select.launches += 1
    return cand, conf


fused_select.launches = 0

