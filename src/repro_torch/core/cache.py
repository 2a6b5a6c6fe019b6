"""Exact block-wise KV and state cache (paper §4.3), ported from the JAX
package's ``core/cache.py``, in its two memory layouts:

- **dense** (:func:`init_cache`): a tuple over period slots of dicts whose
  leaves are stacked over periods: ``{"k": (n_periods, b, max_len, Kv,
  hd), "v": ...}`` for an attention slot, every lane preallocating
  ``max_len`` rows, and in an encoder-decoder the cross attention's
  ``{"ck", "cv"}`` ``(n_periods, b, encoder_seq_len, Kv, hd)``; the
  recurrent state of a Mamba slot (``conv``, ``ssm``) or an RWKV slot
  (``S``, ``tm_shift``, ``cm_shift``), O(1) per lane (:func:`_slots`).
- **paged** (:func:`init_paged_cache`): the K/V leaves are pools
  ``(n_periods, n_pages, page, Kv, hd)`` shared by all lanes, plus a
  per-lane page table mapping sequence-block index -> pool page. Page ``j``
  of a lane holds positions ``[j*page, (j+1)*page)``; entries are ``FREE``
  (-1) until :func:`alloc` assigns a page, so a lane holds pages only for
  the positions it commits. State leaves stay dense.

A commit writes K/V rows at an offset and replaces a state wholesale with
the emitted one (the state after the committed block's last token; the
prefill's ``ck``/``cv``); a state the emission lacks is left as it is.

Unlike the JAX package, whose functions return new buffers, ``reset``,
``commit`` and ``commit_rows`` update the cache **in place** and return
it: a copy of the whole cache per block boundary would cost more than the
block's decode. ``reset`` and ``commit_rows`` touch only the selected
lanes, so a scheduler can recycle one lane while the others keep
decoding, and both dispatch on the layout; ``commit`` writes every lane of
a dense cache at one offset (``commit_at``: an offset on the device).

The paged layout keeps its allocator on the host: ``page_table`` and
``page_owner`` are numpy arrays, and the device holds an int32 copy of the
table, one tensor for the cache's life, into which the table is copied
when it has changed. Allocation is a loop over at most ``batch`` lanes and
never reads the device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.bridge import torch_dtype
from repro_torch.configs.base import (
    MAMBA,
    RWKV,
    RWKV_CM,
    ModelConfig,
    check_supported,
)

DENSE = "dense"
PAGED = "paged"
CACHE_LAYOUTS = (DENSE, PAGED)

FREE = -1  # unallocated page-table entry / unowned pool page
KV = ("k", "v")   # the leaves written at an offset; every other is a state
CROSS = ("ck", "cv")   # an encoder-decoder's cross-attention K/V


def _slots(cfg: ModelConfig, kv_lead: int, kv_rows: int, batch: int, dt,
           dev) -> tuple:
    """Zeroed buffers for every period slot, each stacked over periods:
    ``{"k", "v"}`` ``(n_periods, kv_lead, kv_rows, Kv, hd)`` for an
    attention slot (``ATTN`` and ``ATTN_LOCAL`` alike: a local slot keeps
    every row; its window is applied when it is read), ``conv``
    ``(n_periods, batch, d_conv - 1, e)`` and ``ssm`` ``(n_periods, batch,
    e, N)`` (fp32) for a Mamba slot, ``S`` ``(n_periods, batch, H, hs,
    hs)`` (fp32) and ``tm_shift`` ``(n_periods, batch, d)`` for an RWKV
    slot, ``cm_shift`` ``(n_periods, batch, d)`` where the FFN is
    ``RWKV_CM``, and ``ck``/``cv`` ``(n_periods, batch, encoder_seq_len,
    Kv, hd)`` beside an encoder-decoder's K/V; ``dt`` elsewhere."""
    check_supported(cfg)

    def zeros(*shape, dtype=dt):
        return torch.zeros((cfg.n_periods, *shape), dtype=dtype, device=dev)

    out = []
    for mixer, ffn in cfg.layer_period:
        slot = {}
        if mixer == MAMBA:
            e = cfg.mamba_expand * cfg.d_model
            slot["conv"] = zeros(batch, cfg.mamba_d_conv - 1, e)
            slot["ssm"] = zeros(batch, e, cfg.mamba_d_state,
                                dtype=torch.float32)
        elif mixer == RWKV:
            hs = cfg.rwkv_head_size
            slot["S"] = zeros(batch, cfg.d_model // hs, hs, hs,
                              dtype=torch.float32)
            slot["tm_shift"] = zeros(batch, cfg.d_model)
        else:
            for key in KV:
                slot[key] = zeros(kv_lead, kv_rows, cfg.n_kv_heads,
                                  cfg.head_dim)
            if cfg.is_encoder_decoder:
                # the cross attention's K/V over the encoder's rows: a
                # state, written whole by the prefill's commit
                for key in CROSS:
                    slot[key] = zeros(batch, cfg.encoder_seq_len,
                                      cfg.n_kv_heads, cfg.head_dim)
        if ffn == RWKV_CM:
            slot["cm_shift"] = zeros(batch, cfg.d_model)
        out.append(slot)
    return tuple(out)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device="cuda") -> tuple:
    """Zeroed cache buffers for every period slot."""
    return _slots(cfg, batch, max_len, batch,
                  torch_dtype(dtype or cfg.dtype), resolve_device(device))


def cache_bytes(cache) -> int:
    """Bytes of every buffer of a dense cache, or of a paged cache's pools,
    state leaves and its int32 page table and owners (the JAX
    ``cache_bytes`` counts every leaf of the ``PagedCache``)."""
    if isinstance(cache, PagedCache):
        return (cache_bytes(cache.slots) + cache.page_table.nbytes
                + cache.page_owner.nbytes)
    return sum(buf.numel() * buf.element_size()
               for slot in cache for buf in slot.values())


def _any_leaf(slots) -> torch.Tensor:
    return next(iter(slots[0].values()))


def _kv_len(emissions) -> int:
    """Rows of the first attention slot's K emission (0 without one)."""
    for slot in emissions:
        if "k" in slot:
            return slot["k"].shape[2]
    return 0


def _write_states(cslot: dict, eslot: dict, lanes=None) -> None:
    """Replace a slot's state leaves with its emissions', every lane or
    the lanes of the index tensor ``lanes``, in place. The emission's keys
    are walked, as the reference's commit walks them: a state leaf the
    emission lacks keeps its contents (a cached block forward reads
    ``ck``/``cv`` and emits neither)."""
    for key, val in eslot.items():
        if key in KV or key not in cslot:
            continue
        buf = cslot[key]
        if lanes is None:
            buf.copy_(val)
        else:
            buf[:, lanes] = val[:, lanes].to(buf.dtype)


def _lanes(rows, batch: int) -> np.ndarray:
    """(b,) bool lane mask or int lane indices -> sorted lane indices."""
    rows = np.asarray(rows)
    if rows.dtype == bool:
        if rows.shape != (batch,):
            raise ValueError(f"lane mask of shape {rows.shape}, "
                             f"expected ({batch},)")
        return np.flatnonzero(rows)
    return np.unique(rows.astype(np.int64))


def reset(cache, rows):
    """Zero the selected lanes of every buffer, in place. A
    :class:`PagedCache` returns the lanes' pages to the pool instead and
    zeroes their state leaves (:func:`free`)."""
    if isinstance(cache, PagedCache):
        return free(cache, rows)
    leaf = _any_leaf(cache)
    lanes = torch.as_tensor(_lanes(rows, leaf.shape[1]), device=leaf.device)
    if lanes.numel():
        for slot in cache:
            for buf in slot.values():
                buf[:, lanes] = 0
    return cache


def commit(cache: tuple, emissions: tuple, offset: int) -> tuple:
    """Write a block's emissions into every lane of a dense cache, in
    place (the JAX package's whole-batch ``commit``): K/V emissions
    ``(n_periods, b, L, Kv, hd)`` at the shared sequence ``offset``, state
    emissions in place of the old state."""
    for cslot, eslot in zip(cache, emissions):
        for key in KV:
            if key not in cslot:
                continue
            val, max_len = eslot[key], cslot[key].shape[2]
            if offset < 0 or offset + val.shape[2] > max_len:
                raise ValueError(f"rows [{offset}, {offset + val.shape[2]})"
                                 f" outside a cache of {max_len}")
            cslot[key][:, :, offset:offset + val.shape[2]] = val.to(
                cslot[key].dtype)
        _write_states(cslot, eslot)
    return cache


def commit_at(cache: tuple, emissions: tuple, offset: torch.Tensor) -> tuple:
    """:func:`commit` at a device offset, a 0-dim int64 tensor: no host
    read (a CUDA graph captures it), and no bounds check on the host."""
    n = _kv_len(emissions)
    idx = offset + torch.arange(n, device=offset.device) if n else None
    for cslot, eslot in zip(cache, emissions):
        for key in KV:
            if key in cslot:
                cslot[key].index_copy_(2, idx,
                                       eslot[key].to(cslot[key].dtype))
        _write_states(cslot, eslot)
    return cache


def commit_rows(cache, emissions: tuple, offsets, rows):
    """Write the selected lanes' emissions into their cache rows, in
    place: K/V emissions ``(n_periods, b, L, Kv, hd)`` each lane at its own
    sequence offset, state emissions in place of the lane's old state.
    Lanes outside ``rows`` keep their contents bit for bit. A
    :class:`PagedCache` writes K/V through each lane's page table."""
    if isinstance(cache, PagedCache):
        return _commit_rows_paged(cache, emissions, offsets, rows)
    leaf = _any_leaf(cache)
    batch = leaf.shape[1]
    offsets = np.broadcast_to(np.asarray(offsets, np.int64), (batch,))
    lanes = _lanes(rows, batch)
    for lane in lanes:
        off = int(offsets[lane])
        for cslot, eslot in zip(cache, emissions):
            for key in KV:
                if key not in cslot:
                    continue
                val, max_len = eslot[key][:, lane], cslot[key].shape[2]
                if off < 0 or off + val.shape[1] > max_len:
                    raise ValueError(f"rows [{off}, {off + val.shape[1]}) "
                                     f"outside a cache of {max_len}")
                cslot[key][:, lane, off:off + val.shape[1]] = val.to(
                    cslot[key].dtype)
    if len(lanes):
        idx = torch.as_tensor(lanes, device=leaf.device)
        for cslot, eslot in zip(cache, emissions):
            _write_states(cslot, eslot, idx)
    return cache


def period_commit(cache, offsets, rows):
    """An ``emit`` for ``models.transformer.forward``: it writes each
    period's emissions (per slot, without the period axis) into period
    ``p`` of the selected lanes' rows, in place, as :func:`commit_rows`
    writes every period's; a paged cache's index is built once, at the
    first period."""
    at = []

    def emit(p: int, emissions: tuple) -> None:
        ems = tuple({k: v[None] for k, v in em.items()} for em in emissions)
        if not isinstance(cache, PagedCache):
            commit_rows(_period(cache, p), ems, offsets, rows)
            return
        if not at:
            at.append(_paged_index(cache, _kv_len(ems), offsets, rows))
        if at[0] is not None:
            _write_paged(_period(cache.slots, p), ems, *at[0])

    return emit


def _period(slots, p: int) -> tuple:
    """Views of period ``p`` of every slot's leaves, the period axis kept."""
    return tuple({k: v[p:p + 1] for k, v in slot.items()} for slot in slots)


# ---------------------------------------------------------------------------
# Paged layout
# ---------------------------------------------------------------------------
class PagedCache:
    """Block-paged KV cache: device page pools plus host page tables.

    ``slots``: per period slot ``{"k", "v"}`` pools ``(n_periods, n_pages,
    page, Kv, hd)`` of an attention slot, and the dense state leaves
    ``(n_periods, b, ...)`` of a Mamba or RWKV slot, which are O(1) per
    lane. ``page_table`` (b, n_tables) int32 maps a lane's
    sequence-block index to a pool page (``FREE`` = unallocated);
    ``page_owner`` (n_pages,) int32 records the lane holding each page
    (``FREE`` = available). Both are numpy arrays, changed in place by
    :func:`alloc` and :func:`free`; :meth:`device_table` is the table on the
    pools' device, at one address for the cache's life (a CUDA graph reads
    it there), copied again only after a change.
    """

    def __init__(self, slots: tuple, page_table: np.ndarray,
                 page_owner: np.ndarray):
        self.slots = slots
        self.page_table = page_table
        self.page_owner = page_owner
        self._table_dev = torch.empty(page_table.shape, dtype=torch.int32,
                                      device=self.device)
        self._stale = True

    @property
    def page_size(self) -> int:
        for slot in self.slots:
            if "k" in slot:
                return slot["k"].shape[2]
        raise ValueError("paged cache has no attention slots")

    @property
    def n_pages(self) -> int:
        return self.page_owner.shape[0]

    @property
    def n_lanes(self) -> int:
        return self.page_table.shape[0]

    @property
    def device(self) -> torch.device:
        return _any_leaf(self.slots).device

    def touch(self) -> None:
        """Mark the host table changed: the next :meth:`device_table`
        copies it to the device."""
        self._stale = True

    def device_table(self) -> torch.Tensor:
        """The page table as a (b, n_tables) int32 tensor on the pools'
        device, always the same tensor: the host table is copied into it
        (on the current stream) when it changed since the last call."""
        if self._stale:
            self._table_dev.copy_(torch.from_numpy(self.page_table))
            self._stale = False
        return self._table_dev


def init_paged_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                     n_pages: int, page_size: int, dtype=None,
                     device="cuda") -> PagedCache:
    """A zeroed pool of ``n_pages`` pages, sized independently of
    ``batch * max_len``; ``max_len`` only sets the table width. The state
    leaves stay dense, one per lane. Refuses an attention-free config and
    an encoder-decoder, as the reference does."""
    if cfg.is_attention_free:
        raise ValueError("paged layout needs attention KV; "
                         f"{cfg.name} carries only O(1) recurrent state")
    if cfg.is_encoder_decoder:
        raise ValueError("paged layout does not support encoder-decoder "
                         "cross-attention caches yet")
    n_tables = -(-max_len // page_size)
    slots = _slots(cfg, n_pages, page_size, batch,
                   torch_dtype(dtype or cfg.dtype), resolve_device(device))
    return PagedCache(slots, np.full((batch, n_tables), FREE, np.int32),
                      np.full((n_pages,), FREE, np.int32))


def pages_for_span(start: int, stop: int, page_size: int) -> int:
    """Number of page-table slots covering positions [start, stop)."""
    if stop <= start:
        return 0
    return -(-stop // page_size) - start // page_size


def alloc(paged: PagedCache, rows, starts, stops):
    """Ensure pages covering ``[start, stop)`` are allocated per lane, in
    place. Lanes are served in index order, each all-or-nothing, and take
    the lowest-index free pages first: the JAX allocator's decisions.

    Returns ``(paged, ok)``: ``ok`` (b,) bool marks the selected lanes whose
    span is now fully backed; a lane that could not get every page it
    needed keeps its table row unchanged."""
    b, n_t = paged.page_table.shape
    page = paged.page_size
    lanes = _lanes(rows, b)
    starts = np.broadcast_to(np.asarray(starts, np.int64), (b,))
    stops = np.broadcast_to(np.asarray(stops, np.int64), (b,))
    tids = np.arange(n_t)
    ok = np.zeros((b,), bool)
    changed = False
    for lane in lanes:
        row = paged.page_table[lane]
        covers = (tids * page < stops[lane]) & ((tids + 1) * page
                                                > starts[lane])
        need = np.flatnonzero(covers & (row == FREE))
        free_pages = np.flatnonzero(paged.page_owner == FREE)
        if len(need) > len(free_pages):
            continue
        take = free_pages[:len(need)]
        row[need] = take
        paged.page_owner[take] = lane
        ok[lane] = True
        changed |= len(need) > 0
    if changed:
        paged.touch()
    return paged, ok


def free(paged: PagedCache, rows) -> PagedCache:
    """Return the selected lanes' pages to the pool and zero their state
    leaves, in place. Page contents are left as they are: a page is read
    only below its new owner's ``cache_len``, and every such position is
    committed again first."""
    lanes = _lanes(rows, paged.n_lanes)
    if len(lanes):
        paged.page_owner[np.isin(paged.page_owner, lanes)] = FREE
        paged.page_table[lanes] = FREE
        paged.touch()
        idx = torch.as_tensor(lanes, device=paged.device)
        for slot in paged.slots:
            for key, buf in slot.items():
                if key not in KV:
                    buf[:, idx] = 0
    return paged


def _commit_rows_paged(paged: PagedCache, emissions: tuple, offsets,
                       rows) -> PagedCache:
    """Paged :func:`commit_rows`: the K/V emissions of the selected lanes
    are written through their page tables, one indexed write per slot and
    key, and their state emissions replace the lanes' states. Positions
    on unallocated pages are dropped, as in the JAX package (the engine
    allocates before it commits)."""
    at = _paged_index(paged, _kv_len(emissions), offsets, rows)
    if at is not None:
        _write_paged(paged.slots, emissions, *at)
    return paged


def _paged_index(paged: PagedCache, Lb: int, offsets, rows):
    """Where :func:`_commit_rows_paged` writes ``Lb`` rows of each selected
    lane: the pool (page, row) and emission (lane, row) index tensors of
    every position on an allocated page, and the lanes as a tensor; None
    without a lane."""
    b, n_t = paged.page_table.shape
    page = paged.page_size
    lanes = _lanes(rows, b)
    if not len(lanes):
        return None
    offsets = np.broadcast_to(np.asarray(offsets, np.int64), (b,))
    pos = offsets[lanes, None] + np.arange(Lb)[None, :]     # (n, Lb)
    if pos.min() < 0 or pos.max() >= n_t * page:
        raise ValueError(f"rows [{pos.min()}, {pos.max() + 1}) outside a "
                         f"page table of {n_t * page} positions")
    pid = paged.page_table[lanes[:, None], pos // page]
    li, ji = np.nonzero(pid != FREE)
    dev = paged.device
    idx = [torch.as_tensor(a, device=dev) for a in
           (pid[li, ji], pos[li, ji] % page, lanes[li], ji)]
    return idx, torch.as_tensor(lanes, device=dev)


def _write_paged(slots, emissions: tuple, idx, lanes_t) -> None:
    for cslot, eslot in zip(slots, emissions):
        for key in KV:
            if key in cslot:
                cslot[key][:, idx[0], idx[1]] = eslot[key][
                    :, idx[2], idx[3]].to(cslot[key].dtype)
        _write_states(cslot, eslot, lanes_t)


def gather_dense(paged: PagedCache) -> tuple:
    """The dense-layout view of a paged cache: pools gathered through the
    page tables into ``(n_periods, b, n_tables*page, Kv, hd)`` buffers,
    state leaves as they are.
    Positions on unallocated pages hold another page's bytes; they are
    only read below ``cache_len``. A test and debugging helper: the decode
    reads the pools through the tables."""
    table = torch.as_tensor(np.clip(paged.page_table, 0, paged.n_pages - 1),
                            device=paged.device, dtype=torch.int64)
    b, n_t = table.shape

    def view(pool):
        g = pool[:, table]                    # (np, b, n_t, page, Kv, hd)
        return g.reshape(g.shape[0], b, n_t * paged.page_size, *g.shape[4:])

    return tuple({k: view(v) if k in KV else v for k, v in slot.items()}
                 for slot in paged.slots)


def free_page_count(paged: PagedCache) -> int:
    return int(np.sum(paged.page_owner == FREE))
