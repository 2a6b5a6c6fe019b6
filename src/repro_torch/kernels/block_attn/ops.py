"""Block-causal flash attention: the wrapper of the CUDA kernel
``csrc/block_attn.cu``.

``flash_block_attention`` computes what the JAX package's
``kernels/block_attn/ops.py::flash_block_attention`` computes: attention of
a full sequence under a CDLM visibility mode (bidirectional, causal or
block-causal, with an optional window and softcap) in the model's GQA
layout, returning fp32. The model's prefill calls it
(``models/transformer.py::forward``'s ``prefill_attention_fn``) and the
trajectory collector's forwards. A CPU tensor takes the plain version
(``ref.py``); a CUDA tensor launches the kernel or raises.

The kernel's route is chosen by dtype, and both are kernels: bf16 runs on
the tensor cores (wgmma, K and V tiles by TMA, 128 folded query rows a
block, the probabilities as a bf16 pair), fp32 on CUDA cores in fp32, since
fp32 on the tensor cores would be TF32.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.block_attn import ref

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
             + [ctypes.c_float] * 2 + [ctypes.c_int] + [ctypes.c_void_p])
HEAD_DIMS = (64, 112, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)


def flash_block_attention(q, k, v, *, mode: str = ref.BLOCK_CAUSAL,
                          prompt_len: int = 0, block_size: int = 1,
                          window: Optional[int] = None, scale: float = 1.0,
                          softcap: Optional[float] = None) -> torch.Tensor:
    """q: (b, L, Kv, G, hd); k/v: (b, L, Kv, hd). Query position i sits at
    position i. Returns (b, L, Kv, G, hd) fp32. Refuses inputs that require
    grad while grad mode is on: there is no backward."""
    _build.refuse_grad("flash_block_attention", q, k, v)
    if q.device.type == "cpu":
        return ref.block_attention(q, k, v, mode=mode, prompt_len=prompt_len,
                                   block_size=block_size, window=window,
                                   scale=scale, softcap=softcap)
    b, L, Kv, G, hd = q.shape
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_block_attention: tensors on different "
                         "devices")
    if q.device.type != "cuda":
        raise ValueError(f"flash_block_attention: no kernel for {q.device}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_block_attention: q, k and v must share one "
                         f"dtype of {DTYPES}")
    if mode not in ref.MODES:
        raise ValueError(f"flash_block_attention: unknown mode {mode!r}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_block_attention: head_dim {hd} not in "
                         f"{HEAD_DIMS}")
    if k.shape != (b, L, Kv, hd) or v.shape != k.shape:
        raise ValueError(f"flash_block_attention: shapes q {tuple(q.shape)}"
                         f", k {tuple(k.shape)}, v {tuple(v.shape)} do not "
                         "match")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash_block_attention: q, k and v must be "
                         "contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_block_attention: q, k and v must be 16-byte "
                         "aligned (16-byte loads and TMA)")
    if ((softcap is not None and softcap <= 0)
            or (window is not None and window <= 0) or block_size <= 0
            or prompt_len < 0):
        raise ValueError("flash_block_attention: softcap, window and "
                         "block_size must be positive and prompt_len "
                         "non-negative")
    out = torch.empty((b, L, Kv, G, hd), dtype=torch.float32,
                      device=q.device)
    if out.numel() == 0:
        return out
    fn = _build.function("block_attn_forward", _ARGTYPES)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, L,
            Kv, G, hd, ref.MODES.index(mode), prompt_len, block_size,
            0 if window is None else window, scale,
            0.0 if softcap is None else softcap,
            int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "block_attn_forward")
    flash_block_attention.launches += 1
    return out


flash_block_attention.launches = 0
