"""Plain PyTorch versions of ``csrc/moe.cu``: the dropless grouped expert
product and the layout its kernels share.

:func:`align` is the layout: the pairs ``(token, choice)`` grouped by
expert in pair order, each group padded to ``BM`` rows, the row tiles'
experts and real rows. The kernel's ``moe_align`` gives the same counts,
groups and tiles, with the rows inside a group in the order its atomics
give (no value depends on it). :func:`grouped_experts` computes what the
five kernels compute, rounded to the input dtype at the same points: each
pair's ``x W_gate`` and ``x W_up``, ``silu`` of the first, their product,
the product with ``W_down``; then each token's outputs weighted by its
gates and summed in fp32 in choice order, rounded once. One product per
expert over its rows, so it reads each expert once, as the kernels do."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

BM = 128              # rows of a tile (moe.cu's kBM)


def align(ids: torch.Tensor, n_experts: int):
    """ids (P,) or (T, k) -> (row_of (P,), tile_expert, tile_rows, counts
    (E,)): each pair's row in the expert-grouped, ``BM``-padded layout
    (pairs of one expert in pair order), and each row tile's expert and
    real rows."""
    flat = ids.reshape(-1)
    counts = torch.bincount(flat, minlength=n_experts)
    padded = (counts + BM - 1) // BM * BM
    first = torch.cumsum(padded, 0) - padded
    order = torch.sort(flat, stable=True).indices
    rank = torch.empty_like(flat)
    rank[order] = (torch.arange(len(flat), device=flat.device)
                   - (torch.cumsum(counts, 0) - counts)[flat[order]])
    tiles = padded // BM
    tile_expert = torch.repeat_interleave(
        torch.arange(n_experts, device=flat.device), tiles)
    within = (torch.arange(len(tile_expert), device=flat.device)
              - (torch.cumsum(tiles, 0) - tiles)[tile_expert])
    tile_rows = (counts[tile_expert] - within * BM).clamp_max(BM)
    return first[flat] + rank, tile_expert, tile_rows, counts


def grouped_experts(xt, gates, ids, wi_gate, wi_up, wo, *,
                    tally: Optional[torch.Tensor] = None):
    """xt (T, d); gates (T, k) fp32; ids (T, k) expert ids; wi_gate and
    wi_up (E, d, f), wo (E, f, d) -> (T, d) in xt's dtype. ``tally``
    (E + 1,) int64, where given, gains the pairs of each expert and, last,
    the padded rows the kernels would compute."""
    T, k = ids.shape
    E = wi_gate.shape[0]
    flat = ids.reshape(-1)
    counts = torch.bincount(flat, minlength=E)
    if tally is not None:
        tally[:E] += counts.to(tally.device)
        tally[E] += int(((counts + BM - 1) // BM * BM).sum())
    order = torch.sort(flat, stable=True).indices
    rows = xt[order // k]
    y = torch.empty_like(rows)
    start = 0
    for e, n in enumerate(counts.tolist()):
        if n:
            r = rows[start:start + n]
            h = F.silu(r @ wi_gate[e]) * (r @ wi_up[e])
            y[start:start + n] = h @ wo[e]
            start += n
    per_pair = torch.empty_like(y)
    per_pair[order] = y
    per_pair = per_pair.view(T, k, -1)
    out = torch.zeros(xt.shape, dtype=torch.float32, device=xt.device)
    for j in range(k):
        out = out + per_pair[:, j].float() * gates[:, j, None]
    return out.to(xt.dtype)
