"""The dropless grouped expert product: the wrappers of ``csrc/moe.cu``.

:func:`grouped_experts` maps the routed tokens ``xt`` (T, d), their gates
and expert ids (T, k) and an MoE layer's expert matrices to the layer's
output (T, d), computing every choice of every token (nothing drops). A CPU
tensor takes the plain version (``ref.grouped_experts``); a CUDA tensor
launches the five kernels in order, each through its own wrapper
(:func:`moe_align`, :func:`moe_gather`, :func:`moe_gate_up`,
:func:`moe_down`, :func:`moe_combine`), or raises. The kernels take bf16
(the ids int64, the gates fp32) and have no backward: the forward calls
them only where no gradient is carried, and each wrapper refuses an input
that requires grad in grad mode.

The buffers are sized by the static bound of the padded layout,
``T k + E (BM - 1)`` rows, so no launch depends on a count read on the
host and the whole product is captured into a CUDA graph. Tokens go through
in chunks of ``MAX_TOKENS``, which bounds the buffers of an admission's
prefill (an output row depends on its own token only, so the chunks change
no value). Each wrapper allocates its outputs and counts its launches in
``.launches``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.moe import ref

_P = ctypes.c_void_p
_I = ctypes.c_int
BM = ref.BM
MAX_TOKENS = 8192     # tokens of one chunk: 65,536 pairs at k = 8
MAX_EXPERTS = 1024    # moe_align: one block of 1024 threads


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def max_tiles(n_pairs: int, n_experts: int) -> int:
    """Row tiles of the padded layout's static bound: the sum over experts
    of ceil(count / BM) is at most (pairs + E (BM - 1)) / BM."""
    return (n_pairs + n_experts * (BM - 1)) // BM


def moe_align(ids, n_experts: int, tally: Optional[torch.Tensor] = None):
    """ids (P,) int64 -> (row_of (P,), tile_expert, tile_rows (max_tiles,),
    n_tiles (1,)) int32, all on the device; adds into ``tally``."""
    P = ids.numel()
    tiles = max_tiles(P, n_experts)
    dev = ids.device
    row_of = torch.empty(P, dtype=torch.int32, device=dev)
    tile_expert = torch.empty(tiles, dtype=torch.int32, device=dev)
    tile_rows = torch.empty(tiles, dtype=torch.int32, device=dev)
    n_tiles = torch.empty(1, dtype=torch.int32, device=dev)
    fn = _build.function("moe_align_launch", [_P, _I, _I] + [_P] * 6)
    rc = fn(ids.data_ptr(), P, n_experts, row_of.data_ptr(),
            tile_expert.data_ptr(), tile_rows.data_ptr(), n_tiles.data_ptr(),
            None if tally is None else tally.data_ptr(), _stream(dev))
    _build.check(rc, "moe_align")
    moe_align.launches += 1
    return row_of, tile_expert, tile_rows, n_tiles


def moe_gather(xt, row_of, k: int, rows: int):
    """xs (rows, d): pair p's token row ``xt[p // k]`` at ``row_of[p]``;
    padding rows unwritten."""
    d = xt.shape[1]
    xs = torch.empty((rows, d), dtype=xt.dtype, device=xt.device)
    fn = _build.function("moe_gather_launch", [_P, _P, _I, _I, _I, _P, _P])
    rc = fn(xt.data_ptr(), row_of.data_ptr(), row_of.numel(), k, d,
            xs.data_ptr(), _stream(xt.device))
    _build.check(rc, "moe_gather")
    moe_gather.launches += 1
    return xs


def moe_gate_up(xs, wi_gate, wi_up, layout):
    """h (rows, f) = silu(xs W_gate[e]) * (xs W_up[e]), e each row tile's
    expert (``layout``: :func:`moe_align`'s tiles)."""
    _, tile_expert, tile_rows, n_tiles = layout
    E, d, f = wi_gate.shape
    h = torch.empty((xs.shape[0], f), dtype=xs.dtype, device=xs.device)
    fn = _build.function("moe_gate_up_launch", [_P] * 7 + [_I] * 4 + [_P])
    rc = fn(xs.data_ptr(), wi_gate.data_ptr(), wi_up.data_ptr(),
            tile_expert.data_ptr(), tile_rows.data_ptr(), n_tiles.data_ptr(),
            h.data_ptr(), tile_expert.numel(), E, d, f, _stream(xs.device))
    _build.check(rc, "moe_gate_up")
    moe_gate_up.launches += 1
    return h


def moe_down(h, wo, layout):
    """y (rows, d) = h W_down[e], e each row tile's expert."""
    _, tile_expert, tile_rows, n_tiles = layout
    E, f, d = wo.shape
    y = torch.empty((h.shape[0], d), dtype=h.dtype, device=h.device)
    fn = _build.function("moe_down_launch", [_P] * 6 + [_I] * 4 + [_P])
    rc = fn(h.data_ptr(), wo.data_ptr(), tile_expert.data_ptr(),
            tile_rows.data_ptr(), n_tiles.data_ptr(), y.data_ptr(),
            tile_expert.numel(), E, d, f, _stream(h.device))
    _build.check(rc, "moe_down")
    moe_down.launches += 1
    return y


def moe_combine(y, row_of, gates, out):
    """out (T, d) = sum_j gates[:, j] y[row_of[t k + j]] in fp32, in
    choice order, rounded once."""
    T, k = gates.shape
    fn = _build.function("moe_combine_launch", [_P] * 3 + [_I] * 3 + [_P] * 2)
    rc = fn(y.data_ptr(), row_of.data_ptr(), gates.data_ptr(), T, k,
            y.shape[1], out.data_ptr(), _stream(y.device))
    _build.check(rc, "moe_combine")
    moe_combine.launches += 1
    return out


def _check(xt, gates, ids, wi_gate, wi_up, wo):
    T, d = xt.shape
    E, _, f = wi_gate.shape
    for t in (xt, wi_gate, wi_up, wo):
        if t.device != xt.device or t.dtype != torch.bfloat16:
            raise ValueError("grouped_experts: the kernels take bf16 tensors "
                             f"on one device, got {t.dtype} on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("grouped_experts: tensors must be contiguous "
                             "and 16-byte aligned")
    if (ids.shape != gates.shape or ids.shape[0] != T
            or wi_gate.shape != (E, d, f) or wi_up.shape != (E, d, f)
            or wo.shape != (E, f, d) or d % 128 or f % 64
            or not 0 < E <= MAX_EXPERTS):
        raise ValueError(f"grouped_experts: xt {tuple(xt.shape)}, ids "
                         f"{tuple(ids.shape)}, gates {tuple(gates.shape)}, "
                         f"experts {tuple(wi_gate.shape)} / "
                         f"{tuple(wo.shape)} do not fit (d % 128, f % 64, "
                         f"E <= {MAX_EXPERTS})")


def grouped_experts(xt, gates, ids, wi_gate, wi_up, wo, *,
                    tally: Optional[torch.Tensor] = None):
    """xt (T, d); gates (T, k) fp32; ids (T, k) int expert ids; wi_gate,
    wi_up (E, d, f), wo (E, f, d) -> (T, d) in xt's dtype: every pair's
    ``silu(x W_gate) (x W_up) W_down`` weighted by its gate. ``tally``
    ((E + 1,) int64 on xt's device), where given, gains the pairs routed
    to each expert and, last, the rows the products computed (padding
    included), on the device."""
    _build.refuse_grad("grouped_experts", xt, wi_gate, wi_up, wo)
    if xt.device.type == "cpu":
        return ref.grouped_experts(xt, gates, ids, wi_gate, wi_up, wo,
                                   tally=tally)
    _check(xt, gates, ids, wi_gate, wi_up, wo)
    E, k = wi_gate.shape[0], ids.shape[1]
    ids = ids.to(torch.int64).contiguous()
    gates = gates.float().contiguous()
    out = torch.empty_like(xt)
    for s in range(0, xt.shape[0], MAX_TOKENS):
        x = xt[s:s + MAX_TOKENS]
        layout = moe_align(ids[s:s + MAX_TOKENS].reshape(-1), E, tally)
        rows = layout[1].numel() * BM
        xs = moe_gather(x, layout[0], k, rows)
        h = moe_gate_up(xs, wi_gate, wi_up, layout)
        y = moe_down(h, wo, layout)
        moe_combine(y, layout[0], gates[s:s + MAX_TOKENS],
                    out[s:s + MAX_TOKENS])
    return out


moe_align.launches = 0
moe_gather.launches = 0
moe_gate_up.launches = 0
moe_down.launches = 0
moe_combine.launches = 0
