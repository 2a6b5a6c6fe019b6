"""Exact block-wise KV cache, dense layout (paper §4.3), ported from the JAX
package's ``core/cache.py``.

The cache mirrors the transformer's per-slot emission structure: a tuple
over period slots of dicts whose leaves are stacked over periods,
``{"k": (n_periods, b, max_len, Kv, hd), "v": ...}``.

Unlike the JAX package, whose functions return new buffers, ``reset`` and
``commit_rows`` update the cache **in place** and return it: a copy of the
whole cache per block boundary would cost more than the block's decode.
Both touch only the selected lanes, so a scheduler can recycle one lane
while the others keep decoding.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.bridge import torch_dtype
from repro_torch.configs.base import ModelConfig


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device="cuda") -> tuple:
    """Zeroed cache buffers for every period slot."""
    dev = resolve_device(device)
    shape = (cfg.n_periods, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    dt = torch_dtype(dtype or cfg.dtype)
    return tuple({"k": torch.zeros(shape, dtype=dt, device=dev),
                  "v": torch.zeros(shape, dtype=dt, device=dev)}
                 for _ in cfg.layer_period)


def _lanes(rows, batch: int) -> np.ndarray:
    """(b,) bool lane mask or int lane indices -> sorted lane indices."""
    rows = np.asarray(rows)
    if rows.dtype == bool:
        if rows.shape != (batch,):
            raise ValueError(f"lane mask of shape {rows.shape}, "
                             f"expected ({batch},)")
        return np.flatnonzero(rows)
    return np.unique(rows.astype(np.int64))


def reset(cache: tuple, rows) -> tuple:
    """Zero the selected lanes of every buffer, in place."""
    batch = cache[0]["k"].shape[1]
    lanes = torch.as_tensor(_lanes(rows, batch), device=cache[0]["k"].device)
    if lanes.numel():
        for slot in cache:
            for buf in slot.values():
                buf[:, lanes] = 0
    return cache


def commit_rows(cache: tuple, emissions: tuple, offsets, rows) -> tuple:
    """Write the selected lanes' KV emissions ``(n_periods, b, L, Kv, hd)``
    into their cache rows, each lane at its own sequence offset, in place.
    Lanes outside ``rows`` keep their contents bit for bit."""
    batch, max_len = cache[0]["k"].shape[1:3]
    offsets = np.broadcast_to(np.asarray(offsets, np.int64), (batch,))
    for lane in _lanes(rows, batch):
        off = int(offsets[lane])
        for cslot, eslot in zip(cache, emissions):
            for key, buf in cslot.items():
                val = eslot[key][:, lane]
                if off < 0 or off + val.shape[1] > max_len:
                    raise ValueError(f"rows [{off}, {off + val.shape[1]}) "
                                     f"outside a cache of {max_len}")
                buf[:, lane, off:off + val.shape[1]] = val.to(buf.dtype)
    return cache
