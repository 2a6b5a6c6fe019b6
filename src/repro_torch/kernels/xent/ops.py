"""Fused cross-entropy: the wrapper of ``csrc/xent.cu``.

``fused_xent(hidden, w, targets)`` is the per-token loss
``logsumexp_v(h_t . W_v) - h_t . W_{y_t}`` without a ``(T, V)`` logits
tensor, as the JAX package's ``kernels/xent/ops.py::fused_xent`` computes
it, with the unembedding in the port's ``(V, d)`` layout. It is a
``torch.autograd.Function``: the backward recomputes the logits chunk by
chunk and returns ``dh`` in hidden's dtype and ``dW`` in w's dtype (the
JAX ``_bwd``). A CPU tensor takes the plain versions (``ref.py``); a CUDA
tensor launches the kernels or raises. ``fused_xent.launches`` counts
forward calls that launched the kernel, ``fused_xent.backward_launches``
backward calls.

The kernel's route is chosen by dtype, and both are kernels: bf16 runs on
the tensor cores (wgmma fed by TMA, 128 x 128 tiles, one block per SM), fp32
on CUDA cores in fp32 (64 x 64 tiles, four blocks per SM), since fp32 on the
tensor cores would be TF32. A bf16 launch that fails raises; nothing falls
back to the fp32 route. The forward's vocab tiles per chunk and the
backward's chunk are resolved on the host before each launch by
``kernels/tuning.py`` (``config=`` > the tuned table > the built-in rules,
``_build.chunking`` and :func:`backward_chunk`).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, tuning
from repro_torch.kernels.xent import ref

_FWD_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                 + [ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                 + [ctypes.c_void_p])
DTYPES = (torch.float32, torch.bfloat16)
# (hidden rows, vocab rows) of a forward tile and resident blocks per SM:
# xent.cu's tc::kTile for bf16, kBM / kBN for fp32
TILES = {torch.bfloat16: (128, 128, 1), torch.float32: (64, 64, 4)}
CHUNK_ALIGN = 128   # backward chunks are whole bf16 tiles
# A backward chunk's scratch, 4 bytes per (row, vocab row): fp32
# probabilities, or the bf16 pair e_hi, e_lo. Within 16 MB a chunk's stays
# in the H100's 50 MB L2 from the launch that writes it to the one that
# reads it (the bf16 route keeps two chunks', 32 MB: chunk c + 1's
# probabilities are made while chunk c's gradients are).
PROBS_BYTES = 16 << 20


def backward_chunk(T: int, V: int) -> int:
    """Vocab rows per backward chunk: a multiple of 128 that keeps the
    ``4 T chunk``-byte scratch within ``PROBS_BYTES`` (at least one tile,
    at most the vocabulary rounded up)."""
    chunk = max(CHUNK_ALIGN, (PROBS_BYTES // (4 * max(T, 1)))
                // CHUNK_ALIGN * CHUNK_ALIGN)
    return min(chunk, -(-V // CHUNK_ALIGN) * CHUNK_ALIGN)


def fused_xent(hidden, w, targets, *, softcap: Optional[float] = None,
               config: Optional[tuning.KernelConfig] = None):
    """hidden: (T, d); w: (V, d); targets: (T,) int -> loss (T,) fp32.
    ``hidden`` is made contiguous first. There is no final-logit softcap,
    as in the JAX kernel: a ``softcap`` raises. ``config``: a
    ``tuning.KernelConfig`` whose ``vocab_tiles_per_chunk`` and
    ``bwd_chunk`` win over the table's."""
    if softcap is not None:
        raise ValueError("fused_xent: no final-logit softcap (the JAX kernel "
                         "has none); a softcapped model cannot use it")
    if (hidden.ndim != 2 or w.ndim != 2 or w.shape[1] != hidden.shape[1]
            or targets.shape != hidden.shape[:1]):
        raise ValueError(f"fused_xent: hidden {tuple(hidden.shape)} (T, d), "
                         f"w {tuple(w.shape)} (V, d) and targets "
                         f"{tuple(targets.shape)} (T,) do not match")
    return _FusedXent.apply(hidden.contiguous(), w, targets, config)


fused_xent.launches = 0
fused_xent.backward_launches = 0


class _FusedXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hidden, w, targets, config):
        if hidden.device.type == "cpu":
            loss, logz = ref.xent_streaming(hidden, w, targets)
        else:
            loss, logz = _forward(hidden, w, targets, config)
        ctx.save_for_backward(hidden, w, targets, logz)
        ctx.config = config
        return loss

    @staticmethod
    def backward(ctx, g):
        hidden, w, targets, logz = ctx.saved_tensors
        need_dh, need_dw = ctx.needs_input_grad[:2]
        if hidden.device.type == "cpu":
            # the JAX _bwd: statistics pass, then gradients
            dh, dw = ref.xent_backward(hidden, w, targets, g, need_dw=need_dw)
        else:
            dh, dw = _backward(hidden, w, targets, logz, g, need_dw,
                               ctx.config)
        return (dh if need_dh else None), dw, None, None


def _check(name, hidden, w, targets):
    T, d = hidden.shape
    if w.device != hidden.device or targets.device != hidden.device:
        raise ValueError(f"{name}: tensors on different devices")
    if hidden.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {hidden.device}")
    if hidden.dtype not in DTYPES or w.dtype != hidden.dtype:
        raise ValueError(f"{name}: hidden and w must share one dtype of "
                         f"{DTYPES}")
    if not (hidden.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{name}: hidden and w must be contiguous")
    if d % 8 or hidden.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError(f"{name}: d must be a multiple of 8 and the buffers "
                         "16-byte aligned (8-element vector loads)")
    if w.shape[0] == 0:
        raise ValueError(f"{name}: empty vocabulary")
    return targets.to(torch.int32).contiguous()


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _knobs(hidden, V, config):
    """The resolved ``tuning.KernelConfig`` of one call."""
    return tuning.resolve(
        "xent", config=config, backend_name=tuning.backend(hidden.device),
        T=hidden.shape[0], V=V, dtype=hidden.dtype,
        n_sms=torch.cuda.get_device_properties(
            hidden.device).multi_processor_count)


def _forward(hidden, w, targets, config=None):
    y = _check("fused_xent", hidden, w, targets)
    T, d = hidden.shape
    V = w.shape[0]
    loss = torch.empty((T,), dtype=torch.float32, device=hidden.device)
    logz = torch.empty_like(loss)
    if T == 0:
        return loss, logz
    per_chunk = _knobs(hidden, V, config).vocab_tiles_per_chunk
    n_chunks = _build.n_chunks(V, TILES[hidden.dtype][1], per_chunk)
    part = torch.empty((3, n_chunks, T), dtype=torch.float32,
                       device=hidden.device)
    fn = _build.function("xent_forward", _FWD_ARGTYPES)
    rc = fn(hidden.data_ptr(), w.data_ptr(), y.data_ptr(), loss.data_ptr(),
            logz.data_ptr(), part[0].data_ptr(), part[1].data_ptr(),
            part[2].data_ptr(), T, V, d, per_chunk, n_chunks,
            int(hidden.dtype == torch.bfloat16), _stream(hidden))
    _build.check(rc, "xent_forward")
    fused_xent.launches += 1
    return loss, logz


def _backward(hidden, w, targets, logz, g, need_dw, config=None):
    y = _check("fused_xent backward", hidden, w, targets)
    T, d = hidden.shape
    V = w.shape[0]
    g = g.to(device=hidden.device, dtype=torch.float32).contiguous()
    dh = torch.empty_like(hidden)
    dw = torch.empty_like(w) if need_dw else None
    if T == 0:
        return dh, None if dw is None else dw.zero_()
    chunk = min(_knobs(hidden, V, config).bwd_chunk,
                -(-V // CHUNK_ALIGN) * CHUNK_ALIGN)
    dh_acc = torch.empty((T, d), dtype=torch.float32, device=hidden.device)
    if hidden.dtype == torch.bfloat16:   # two chunks' pairs e_hi, e_lo
        probs = torch.empty((2, 2, T, chunk), dtype=torch.bfloat16,
                            device=hidden.device)
    else:                                # one chunk's probabilities
        probs = torch.empty((T, chunk), dtype=torch.float32,
                            device=hidden.device)
    fn = _build.function("xent_backward", _BWD_ARGTYPES)
    rc = fn(hidden.data_ptr(), w.data_ptr(), y.data_ptr(), logz.data_ptr(),
            g.data_ptr(), dh.data_ptr(), None if dw is None else dw.data_ptr(),
            dh_acc.data_ptr(), probs.data_ptr(), T, V, d, chunk,
            int(hidden.dtype == torch.bfloat16), _stream(hidden))
    _build.check(rc, "xent_backward")
    fused_xent.backward_launches += 1
    return dh, dw
