"""Plain PyTorch version of the decode attention kernel.

The same math as the JAX package's ``kernels/decode_attn``: online-softmax
partials of the block's queries over the cache rows below each lane's
``cache_len`` (``decode_attention_partial``), the in-block part
(``_block_partial``), and their merge (``softmax_combine``). The GQA group
is folded into the query rows: row ``r = qpos * G + g``.

Where the JAX package takes one scalar ``cache_len`` (its engine vmaps over
lanes), this version takes ``cache_lens (b,)``, and reads the cache in its
``(b, S, Kv, hd)`` model layout. ``paged_decode_attention`` is the plain
version of the paged kernel: the JAX oracle's gather into the dense view,
then the dense math.

``split_plan`` and ``decode_attention_split`` model how the bf16 kernel
splits the work: each lane's keys in 64-key tiles (the cache rows below
``cache_len``, then the block's fresh keys), a fixed number of tiles per
split, one set of online-softmax partials per split, merged in split order.
The CPU tests hold the model against the plain version and the JAX kernel;
nothing on the main path calls it.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def decode_attention_partial(q, k_cache, v_cache, cache_lens, *,
                             scale: float = 1.0,
                             softcap: Optional[float] = None,
                             window: Optional[int] = None, g: int = 1):
    """q: (b, Kv, R, hd) with R = Bq*G; cache: (b, S, Kv, hd);
    cache_lens: (b,) int. Returns unnormalized fp32 partials
    (acc (b, Kv, R, hd), m (b, Kv, R, 1), l (b, Kv, R, 1)) over cache slots
    below ``cache_lens``; a row that sees no slot gets m = -inf, l = 0."""
    b, Kv, R, hd = q.shape
    S = k_cache.shape[1]
    s = torch.einsum("bkrh,bskh->bkrs", q.float() * scale, k_cache.float())
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    kpos = torch.arange(S, device=q.device)
    lens = cache_lens.to(q.device).long()[:, None, None, None]
    vis = kpos < lens                                    # (b, 1, 1, S)
    if window is not None:
        qpos = lens + (torch.arange(R, device=q.device) // g)[:, None]
        vis = vis & (qpos - kpos < window)               # (b, 1, R, S)
    s = torch.where(vis, s, torch.full_like(s, NEG_INF))
    any_vis = vis.any(-1, keepdim=True)
    m = torch.where(any_vis, s.amax(-1, keepdim=True),
                    torch.full_like(s[..., :1], -torch.inf))
    p = torch.where(vis, torch.exp(s - torch.where(any_vis, m, 0.0)),
                    torch.zeros_like(s))
    acc = torch.einsum("bkrs,bskh->bkrh", p, v_cache.float())
    return acc, m, p.sum(-1, keepdim=True)


def _block_partial(q, k_blk, v_blk, *, scale: float,
                   softcap: Optional[float], window: Optional[int], g: int):
    """In-block (R x Bq) partials. q: (b, Kv, R, hd); k/v_blk: (b, Bq, Kv,
    hd). Within the block every position sees every other (CDLM
    refinement), cut by ``|qpos - kpos| < window``."""
    s = torch.einsum("bkrh,bskh->bkrs", q.float(), k_blk.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    if window is not None:
        R, Bq = q.shape[2], k_blk.shape[1]
        qpos = (torch.arange(R, device=q.device) // g)[:, None]
        kpos = torch.arange(Bq, device=q.device)[None, :]
        s = torch.where((qpos - kpos).abs() < window, s,
                        torch.full_like(s, NEG_INF))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    acc = torch.einsum("bkrs,bskh->bkrh", p, v_blk.float())
    return acc, m, p.sum(-1, keepdim=True)


def softmax_combine(parts):
    """Merge [(acc, m, l), ...] unnormalized online-softmax partials."""
    m = parts[0][1]
    for part in parts[1:]:
        m = torch.maximum(m, part[1])
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    acc = l = 0
    for p_acc, p_m, p_l in parts:
        w = torch.where(torch.isfinite(p_m), torch.exp(p_m - m_safe),
                        torch.zeros_like(p_m))
        acc = acc + p_acc * w
        l = l + p_l * w
    return acc / l.clamp_min(1e-30)


def decode_attention(q, k_cache, v_cache, k_blk, v_blk, cache_lens, *,
                     scale: float = 1.0, softcap: Optional[float] = None,
                     window: Optional[int] = None):
    """q: (b, Bq, Kv, G, hd); k/v_cache: (b, S, Kv, hd); k/v_blk: (b, Bq,
    Kv, hd); cache_lens: (b,) int. Query i of lane j sits at position
    ``cache_lens[j] + i``. Returns (b, Bq, Kv, G, hd) fp32."""
    b, Bq, Kv, G, hd = q.shape
    qf = q.permute(0, 2, 1, 3, 4).reshape(b, Kv, Bq * G, hd)
    cache_part = decode_attention_partial(qf, k_cache, v_cache, cache_lens,
                                          scale=scale, softcap=softcap,
                                          window=window, g=G)
    blk_part = _block_partial(qf, k_blk, v_blk, scale=scale, softcap=softcap,
                              window=window, g=G)
    out = softmax_combine([cache_part, blk_part])
    return out.reshape(b, Kv, Bq, G, hd).permute(0, 2, 1, 3, 4)


def gather_pages(pool, page_table):
    """Dense per-lane view of one period's page pool. pool: (n_pages, page,
    Kv, hd); page_table: (b, n_t) int (-1 = unallocated). Returns (b,
    n_t*page, Kv, hd); unallocated entries read page 0, which is only ever
    at or past the lane's ``cache_len``."""
    b, n_t = page_table.shape
    g = pool[page_table.long().clamp(0, pool.shape[0] - 1)]
    return g.reshape(b, n_t * pool.shape[1], *pool.shape[2:])


def paged_decode_attention(q, k_pages, v_pages, k_blk, v_blk, page_table,
                           cache_lens, *, scale: float = 1.0,
                           softcap: Optional[float] = None,
                           window: Optional[int] = None):
    """Decode attention over a block-paged pool: each lane's pages gathered
    into the dense view, then :func:`decode_attention`, so that on an
    identity table it equals the dense version bit for bit. q: (b, Bq, Kv,
    G, hd); k/v_pages: (n_pages, page, Kv, hd); page_table: (b, n_t) int;
    cache_lens: (b,) int. Returns (b, Bq, Kv, G, hd) fp32."""
    return decode_attention(q, gather_pages(k_pages, page_table),
                            gather_pages(v_pages, page_table), k_blk, v_blk,
                            cache_lens, scale=scale, softcap=softcap,
                            window=window)


KEY_TILE = 64   # keys per tile of the bf16 kernel
MAX_TILES_PER_SPLIT = 8   # decode_attn.cu's kMaxT


def tiles_per_split(Kv: int, rows: int) -> int:
    """Key tiles each split of the bf16 kernel walks, from the KV heads and
    the folded rows Bq * G only (never from the cache length or layout, so
    the dense and paged kernels split alike): 2 where a lane brings at most
    8 (KV head, 64-row tile) pairs (qwen2-0.5b: 2 x 4), so short splits fill
    the card; 8 where it brings more (dream-7b: 4 x 4, llada-8b: 32 x 1),
    so fewer partials are written and merged."""
    return 2 if Kv * -(-rows // 64) <= 8 else 8


def split_plan(Kv: int, Bq: int, G: int, S: int,
               tiles: Optional[int] = None):
    """(tiles per split, splits in the grid) for caches of S rows: a lane
    has at most ceil(S / 64) cache tiles and ceil(Bq / 64) fresh ones.
    ``tiles`` per split: the resolved knob of ``kernels/tuning.py``, else
    :func:`tiles_per_split`."""
    T = tiles or tiles_per_split(Kv, Bq * G)
    n_tiles = -(-S // KEY_TILE) + -(-Bq // KEY_TILE)
    return T, -(-n_tiles // T)


def _bf16_pair(p):
    hi = p.bfloat16().float()
    return hi + (p - hi).bfloat16().float()


def decode_attention_split(q, k_cache, v_cache, k_blk, v_blk, cache_lens, *,
                           scale: float = 1.0,
                           softcap: Optional[float] = None,
                           window: Optional[int] = None, page_table=None,
                           p_round: Optional[str] = None,
                           tiles: Optional[int] = None):
    """The bf16 kernel's split of :func:`decode_attention`, in fp32.

    Lane j's logical key tiles are its ceil(c / 64) cache tiles (c =
    ``cache_lens[j]``; keys at or past c invisible) and then ceil(Bq / 64)
    tiles of the block's fresh keys; split s walks tiles [s T, s T + T)
    (T = ``tiles``, else ``tiles_per_split``), and its partials (acc, m,
    l) over those keys are merged in split order by
    :func:`softmax_combine`. With ``page_table``
    the caches are pools (n_pages, page, Kv, hd) and cache key kp sits at
    row kp % page of page ``page_table[j, kp // page]`` (a -1 page's keys
    are invisible and never read). ``p_round`` models the rounding of the
    probabilities before the PV product: None (fp32), "pair" (p_hi + p_lo,
    the kernel's form) or "bf16" (one rounding). Returns (b, Bq, Kv, G, hd)
    fp32."""
    b, Bq, Kv, G, hd = q.shape
    R = Bq * G
    S = (k_cache.shape[1] if page_table is None
         else page_table.shape[1] * k_cache.shape[1])
    T = tiles or tiles_per_split(Kv, R)
    nb = -(-Bq // KEY_TILE)
    qpos = torch.arange(R, device=q.device) // G
    rnd = {None: lambda p: p, "pair": _bf16_pair,
           "bf16": lambda p: p.bfloat16().float()}[p_round]
    out = []
    for j in range(b):
        c = min(max(int(cache_lens[j]), 0), S)
        nc = -(-c // KEY_TILE)
        n_keys = (nc + nb) * KEY_TILE
        kl = torch.zeros((n_keys, Kv, hd), device=q.device)
        vl = torch.zeros_like(kl)
        ok = torch.zeros(n_keys, dtype=torch.bool, device=q.device)
        kp = torch.arange(c, device=q.device)
        if page_table is None:
            kl[:c], vl[:c] = k_cache[j, :c].float(), v_cache[j, :c].float()
            ok[:c] = True
        else:
            pid = page_table[j].long()[kp // k_cache.shape[1]]
            got = pid >= 0
            page, row = pid[got], (kp % k_cache.shape[1])[got]
            kl[kp[got]] = k_cache[page, row].float()
            vl[kp[got]] = v_cache[page, row].float()
            ok[kp[got]] = True
        f0 = nc * KEY_TILE
        kl[f0:f0 + Bq], vl[f0:f0 + Bq] = k_blk[j].float(), v_blk[j].float()
        ok[f0:f0 + Bq] = True
        # (Kv, R, keys) scores of this lane, softcap, then visibility
        qj = q[j].permute(1, 0, 2, 3).reshape(Kv, R, hd).float()
        s = torch.einsum("krh,nkh->krn", qj, kl) * scale
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        vis = ok[None, :].expand(R, n_keys)
        if window is not None:
            pos = torch.arange(n_keys, device=q.device)
            cache_vis = (c + qpos[:, None]) - pos[None, :] < window
            blk_vis = (qpos[:, None] - (pos[None, :] - f0)).abs() < window
            vis = vis & torch.where(pos[None, :] < f0, cache_vis, blk_vis)
        s = torch.where(vis, s, torch.full_like(s, -torch.inf))
        parts = []
        for t0 in range(0, nc + nb, T):
            sl = slice(t0 * KEY_TILE, min(t0 + T, nc + nb) * KEY_TILE)
            ss = s[..., sl]
            m = ss.amax(-1, keepdim=True)
            p = torch.exp(ss - torch.where(torch.isfinite(m), m, 0.0))
            parts.append((torch.einsum("krn,nkh->krh", rnd(p), vl[sl]), m,
                          p.sum(-1, keepdim=True)))
        o = softmax_combine(parts)
        out.append(o.reshape(Kv, Bq, G, hd).permute(1, 0, 2, 3))
    return torch.stack(out)
