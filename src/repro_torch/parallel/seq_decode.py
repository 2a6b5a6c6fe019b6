"""Sequence-parallel decode attention on ``torch.distributed``, the
counterpart of the JAX package's ``parallel/seq_decode.py``.

For long-context decode the KV cache dominates memory: sharding its
sequence dim over ``n`` ranks gives each ``S/n`` rows. The softmax then
spans ranks: each rank computes the unnormalized partials ``(acc, m, l)``
of its rows, and three small collectives over ``(b, Kv, Bq*G, .)`` merge
them (a max of ``m``, then sums of the rescaled ``acc`` and ``l``), in
place of gathering the cache. The active block's own keys and the final
merge are computed on every rank, as the reference does after its
``shard_map``.

Like the reference, this reaches no kernel: the local partial is plain
PyTorch in fp32. ``make_sharded_decode_attention`` returns a function of
the port forward's ``decode_attention_fn`` signature.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _local_partial(q, kc, vc, *, first_pos: int, cache_lens, scale: float,
                   softcap, window, g: int):
    """Partials over this rank's rows. q: (b, Bq*G, Kv, hd); kc/vc: (b,
    S_loc, Kv, hd), row j at absolute position ``first_pos + j``;
    cache_lens: (b,). Returns acc (b, Kv, Bq*G, hd), m and l (b, Kv,
    Bq*G, 1), fp32."""
    S_loc = kc.shape[1]
    dev = q.device
    s = torch.einsum("bqkh,bskh->bkqs", q.float(), kc.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    kpos = first_pos + torch.arange(S_loc, device=dev)
    valid = kpos[None, :] < cache_lens[:, None]                 # (b, S)
    if window is not None:
        qpos = cache_lens[:, None] + torch.arange(q.shape[1], device=dev) // g
        valid = valid[:, None, :] & (qpos[:, :, None] - kpos < window)
        s = torch.where(valid[:, None], s, NEG_INF)
    else:
        s = torch.where(valid[:, None, None, :], s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    finite = torch.isfinite(m)
    p = torch.exp(s - torch.where(finite, m, 0.0))
    p = torch.where(finite, p, 0.0)
    l = p.sum(-1, keepdim=True)
    acc = torch.einsum("bkqs,bskh->bkqh", p, vc.float())
    return acc, m, l


def make_sharded_decode_attention(group=None, *, axis_size: int,
                                  axis_rank: int):
    """Returns ``fn(q, kc, vc, k_blk, v_blk, cache_lens, *, scale,
    softcap=None, window=None)`` for ranks ``0 .. axis_size - 1`` of
    ``group`` (``None``: the default group), each holding rows ``[rank *
    S_loc, (rank + 1) * S_loc)`` of the cache as ``kc``/``vc`` (b, S_loc,
    Kv, hd). q: (b, Bq, Kv, G, hd); k/v_blk: (b, Bq, Kv, hd); cache_lens:
    (b,) or a scalar. Returns (b, Bq, Kv, G, hd) in q's dtype. At
    ``axis_size`` 1 no collective is issued."""
    import torch.distributed as dist

    def fn(q, kc, vc, k_blk, v_blk, cache_lens, *, scale, softcap=None,
           window=None):
        b, Bq, Kv, G, hd = q.shape
        qf = q.permute(0, 1, 3, 2, 4).reshape(b, Bq * G, Kv, hd)
        clen = torch.as_tensor(cache_lens, device=q.device).to(
            torch.int64).expand(b)
        acc, m, l = _local_partial(
            qf, kc, vc, first_pos=axis_rank * kc.shape[1], cache_lens=clen,
            scale=scale, softcap=softcap, window=window, g=G)
        # merge partials across ranks: 3 small collectives
        if axis_size > 1:
            m_glob = m.clone()
            dist.all_reduce(m_glob, op=dist.ReduceOp.MAX, group=group)
        else:
            m_glob = m
        m_safe = torch.where(torch.isfinite(m_glob), m_glob, 0.0)
        w = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        acc, l = acc * w, l * w
        if axis_size > 1:
            dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=group)
            dist.all_reduce(l, op=dist.ReduceOp.SUM, group=group)
        m = m_glob

        # the in-block part (tiny) and the final merge, on every rank
        kb = k_blk.permute(0, 2, 1, 3).reshape(b * Kv, Bq, hd)
        vb = v_blk.permute(0, 2, 1, 3).reshape(b * Kv, Bq, hd)
        qb = qf.permute(0, 2, 1, 3).reshape(b * Kv, Bq * G, hd)
        s = torch.einsum("bqh,bkh->bqk", qb.float(), kb.float()) * scale
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        if window is not None:
            qpos = torch.arange(Bq * G, device=q.device)[:, None] // G
            kpos = torch.arange(Bq, device=q.device)[None, :]
            s = torch.where((qpos - kpos).abs() < window, s, NEG_INF)
        mb = s.amax(-1, keepdim=True)
        pb = torch.exp(s - mb)
        lb = pb.sum(-1, keepdim=True)
        accb = torch.einsum("bqk,bkh->bqh", pb, vb.float())
        accb = accb.reshape(b, Kv, Bq * G, hd)
        mb = mb.reshape(b, Kv, Bq * G, 1)
        lb = lb.reshape(b, Kv, Bq * G, 1)

        m_tot = torch.maximum(m, mb)
        m_safe = torch.where(torch.isfinite(m_tot), m_tot, 0.0)
        w1 = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        w2 = torch.where(torch.isfinite(mb), torch.exp(mb - m_safe), 0.0)
        out = (acc * w1 + accb * w2) / torch.clamp_min(l * w1 + lb * w2,
                                                       1e-30)
        out = out.reshape(b, Kv, Bq, G, hd).permute(0, 2, 1, 3, 4)
        return out.to(q.dtype)

    return fn
