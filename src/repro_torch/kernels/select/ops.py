"""Fused unembed + greedy select: the wrapper of ``csrc/select.cu``.

``fused_select`` maps hidden states ``(..., d)`` and the ``(V, d)``
unembedding to the argmax token of each row's softmax and its probability,
without a ``(..., V)`` logits tensor, as the JAX package's
``kernels/select/ops.py::fused_select`` does. A CPU tensor takes the plain
online version (``ref.select_streaming``); a CUDA tensor launches the
kernel or raises.

The kernel's route is chosen by dtype, and both are kernels: bf16 runs on
the tensor cores (wgmma fed by TMA, 128 x 128 logit tiles, one block per
SM, the fused cross-entropy's mainloop), fp32 on CUDA cores in fp32 (64 x
64 tiles, four blocks per SM), since fp32 on the tensor cores would be
TF32. The bf16 route reads W through a TMA tensor map encoded once per
weight (``_w_map``): W is the same tied embedding on every call. The
vocab tiles per chunk are resolved on the host before the launch by
``kernels/tuning.py`` (``config=`` > the tuned table > the built-in rule,
``_build.chunking``).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, tuning
from repro_torch.kernels.select import ref

_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_float]
             + [ctypes.c_int] + [ctypes.c_void_p])
_MAP_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                 ctypes.c_int]
DTYPES = (torch.float32, torch.bfloat16)
# (hidden rows per block, vocab rows per tile, resident blocks per SM the
# vocab split aims for): select.cu's tc::kTile for bf16, kBM / kBN for fp32
TILES = {torch.bfloat16: (128, 128, 1), torch.float32: (64, 64, 4)}
MAP_BYTES = 128          # sizeof(CUtensorMap)
_W_MAPS: dict = {}       # (device, data_ptr, V, d) -> W's encoded TMA map
_W_MAPS_MAX = 8


def fused_select(hidden, w, masked, *, softcap: Optional[float] = None,
                 config: Optional[tuning.KernelConfig] = None):
    """hidden: (..., d); w: (V, d); masked: (...) bool (False = finalized
    row) -> (cand (...) int32, conf (...) fp32). ``config``: a
    ``tuning.KernelConfig`` whose ``vocab_tiles_per_chunk`` wins over the
    table's. Refuses inputs that require grad while grad mode is on: there
    is no backward."""
    _build.refuse_grad("fused_select", hidden, w)
    lead = hidden.shape[:-1]
    h2 = hidden.reshape(-1, hidden.shape[-1])
    m2 = masked.reshape(-1)
    if h2.device.type == "cpu":
        cand, conf = ref.select_streaming(h2, w, m2, softcap=softcap)
    else:
        cand, conf = _launch(h2, w, m2, softcap, config)
    return cand.reshape(lead), conf.reshape(lead)


def _launch(h, w, masked, softcap, config):
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
    per_chunk = tuning.resolve(
        "select", config=config, backend_name=tuning.backend(h.device), T=T,
        V=V, n_sms=n_sms, dtype=h.dtype).vocab_tiles_per_chunk
    n_chunks = _build.n_chunks(V, TILES[h.dtype][1], per_chunk)
    bf16 = h.dtype == torch.bfloat16
    part_m = torch.empty((n_chunks, T), dtype=torch.float32, device=h.device)
    part_l = torch.empty_like(part_m)
    part_i = torch.empty((n_chunks, T), dtype=torch.int32, device=h.device)
    mask_i32 = masked.to(torch.int32)
    fn = _build.function("select_forward", _ARGTYPES)
    rc = fn(h.data_ptr(), w.data_ptr(), _w_map(w) if bf16 else None,
            mask_i32.data_ptr(), cand.data_ptr(), conf.data_ptr(),
            part_m.data_ptr(), part_l.data_ptr(), part_i.data_ptr(), T, V, d,
            per_chunk, n_chunks, 0.0 if softcap is None else softcap,
            int(bf16), torch.cuda.current_stream(h.device).cuda_stream)
    _build.check(rc, "select_forward")
    fused_select.launches += 1
    return cand, conf


def _w_map(w):
    """W's TMA tensor map, encoded on first use and kept per (device,
    data_ptr, V, d): the map holds only the address, shape and strides, so
    it is right for whatever tensor lies there with that shape."""
    key = (w.device.index, w.data_ptr(), *w.shape)
    buf = _W_MAPS.get(key)
    if buf is None:
        if len(_W_MAPS) >= _W_MAPS_MAX:
            _W_MAPS.clear()
        buf = ctypes.create_string_buffer(MAP_BYTES)
        fn = _build.function("select_encode_map", _MAP_ARGTYPES)
        _build.check(fn(buf, w.data_ptr(), w.shape[0], w.shape[1]),
                     "select_encode_map")
        _W_MAPS[key] = buf
    return buf


fused_select.launches = 0

