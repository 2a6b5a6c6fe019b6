#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each timed, any failure raises and exits non-zero:

1. card and build: the card's name and power limit, torch and CUDA
   versions, and an nvcc build of every kernel source of the checkout;
2. every kernel against its plain PyTorch version on the card, at the main
   path's shapes (and small softcap / window / mode cases), each timed with
   CUDA events beside its plain version and one PyTorch yardstick call; the
   paged decode kernel also equals the dense one bit for bit on identity
   and permuted page tables;
3. the main path, dense layout: ``ContinuousEngine`` serving CDLM decoding
   of qwen2-0.5b at full width (24 layers, d=896, V=151,936, bf16, seeded
   random init), 12 requests of mixed ``max_tokens`` through 8 lanes, the
   prompt prefill through the block attention kernel, the decode through
   the dense decode attention and fused select kernels; the kernels' launch
   counters must equal the engine's call accounting;
3b. the main path, paged layout, same trace and width: with a
   dense-equivalent pool, tokens equal phase 3's and every cached forward
   goes through the paged kernel; with a tight pool (40 pages of 32
   tokens, the first 8 requests), at least one stall round and one
   preemption, the pool fully free at the end, tokens equal phase 3's;
4. kernel path against plain path: the first block of a 2-request trace
   decoded at fp32 with the kernels (block attention prefill, dense and
   paged decode attention, fused select) and with their plain versions,
   token for token (a divergence is accepted only at a near-tie, printed
   with its gap); the dense and paged kernel paths agree bit for bit.

The line before the last two is the kernels' JSON summary, then the card's
``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device, or outside a checkout, it exits non-zero and prints
no result.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PEAK_BYTES = 3.35e12                      # H100 SXM HBM3, bytes/s
PEAK_OPS = {"bfloat16": 989e12,           # dense tensor-core bf16, FLOP/s
            "float32": 67e12}             # fp32 outside the tensor cores
DECODE_SRC = "src/repro_torch/kernels/decode_attn/csrc/decode_attn.cu"
DECODE_TPU = "src/repro/kernels/decode_attn/decode_attn.py:93"
SELECT_SRC = "src/repro_torch/kernels/select/csrc/select.cu"
SELECT_TPU = "src/repro/kernels/select/select.py:88"
PAGED_TPU = "src/repro/kernels/decode_attn/decode_attn.py:198"
BLOCK_SRC = "src/repro_torch/kernels/block_attn/csrc/block_attn.cu"
BLOCK_TPU = "src/repro/kernels/block_attn/block_attn.py:96"
KERNELS = ("decode_attention", "fused_select", "paged_decode_attention",
           "block_attention")
NEAR_TIE = 1e-4


def log(msg):
    print(msg, flush=True)


def nvidia_smi():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters):
    """Mean ms per call over ``iters`` back-to-back calls (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters, kernels):
    """Device time per call of the CUDA kernels whose names contain one of
    ``kernels``, from the profiler's trace (None if it records none)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for ev in prof.key_averages():
        if any(k in ev.key for k in kernels):
            total += getattr(ev, "self_device_time_total",
                             getattr(ev, "self_cuda_time_total", 0.0))
    return total / iters / 1e3 if total else None


def alternate(torch, plain, kernel, library, iters):
    """plain, kernel, library, library, kernel, plain: means per side."""
    order = [("plain", plain), ("kernel", kernel), ("library", library),
             ("library", library), ("kernel", kernel), ("plain", plain)]
    got = {}
    for name, fn in order:
        if fn is not None:
            got.setdefault(name, []).append(time_ms(torch, fn, iters))
    return {k: sum(v) / len(v) for k, v in got.items()}


def bound_ms(n_bytes, n_ops, dtype):
    t_bytes = n_bytes / PEAK_BYTES
    t_ops = n_ops / PEAK_OPS[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else \
        "operations"


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def check_decode(torch, dev, *, b, Bq, Kv, G, hd, S, lens, dtype,
                 softcap=None, window=None, timed=False, name=""):
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attn import decode_attention
    from repro_torch.kernels.decode_attn import ref as dref
    dt = getattr(torch, dtype)
    g = torch.Generator(device=dev).manual_seed(len(name))
    rnd = lambda *s: torch.randn(s, generator=g, device=dev).to(dt)  # noqa
    q = rnd(b, Bq, Kv, G, hd)
    kc = rnd(2, b, S, Kv, hd)[1]          # a period slice: strided lanes
    vc = rnd(2, b, S, Kv, hd)[1]
    kb, vb = rnd(b, Bq, Kv, hd), rnd(b, Bq, Kv, hd)
    cl = torch.tensor(lens, dtype=torch.int32, device=dev)
    scale = hd ** -0.5
    kw = dict(scale=scale, softcap=softcap, window=window)
    got = decode_attention(q, kc, vc, kb, vb, cl, **kw)
    want = dref.decode_attention(q, kc, vc, kb, vb, cl, **kw)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    # both sides read the same inputs and accumulate in fp32
    tol = 1e-4
    if not err <= tol:
        raise AssertionError(f"decode_attention {name}: max error {err} "
                             f"> {tol}")
    rec = {"kernel": "decode_attention", "case": name, "dtype": dtype,
           "shape": dict(b=b, Bq=Bq, Kv=Kv, G=G, hd=hd, S=S, lens=lens),
           "max_abs_err": err, "tol": tol}
    if timed:
        H, Lk = Kv * G, S + Bq
        qs = q.permute(0, 2, 3, 1, 4).reshape(b, H, Bq, hd)
        ks = torch.cat([kc, kb], 1).permute(0, 2, 1, 3).contiguous()
        vs = torch.cat([vc, vb], 1).permute(0, 2, 1, 3).contiguous()
        slot = torch.arange(Lk, device=dev)
        mask = ((slot[None, :] < cl[:, None]) | (slot[None, :] >= S))
        mask = mask[:, None, None, :].expand(b, 1, Bq, Lk)
        library = (lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, scale=scale, enable_gqa=True))
        times = alternate(
            torch, lambda: dref.decode_attention(q, kc, vc, kb, vb, cl, **kw),
            lambda: decode_attention(q, kc, vc, kb, vb, cl, **kw),
            library, iters=50)
        item = q.element_size()
        n_keys = sum(lens) + b * Bq
        n_bytes = (q.numel() * item + 2 * Kv * hd * item * sum(lens)
                   + (kb.numel() + vb.numel()) * item + got.numel() * 4
                   + 4 * b)
        n_ops = 4 * Kv * Bq * G * hd * n_keys
        bms, by = bound_ms(n_bytes, n_ops, dtype)
        rec.update(kernel_ms=times["kernel"], plain_ms=times["plain"],
                   library_ms=times["library"], bound_ms=bms, bound_by=by,
                   kernel_device_ms=device_ms(
                       torch, lambda: decode_attention(q, kc, vc, kb, vb, cl,
                                                       **kw),
                       50, ["decode_attn_kernel"]))
    log(json.dumps(rec))
    return rec


def _paged_pool(torch, dev, kc, vc, lens, page, perm_gen):
    """The dense caches' rows moved page by page into a pool of 3x the pages
    needed, at shuffled places; table entries past each lane's length are
    -1. Returns (k_pool, v_pool, table)."""
    b, S, Kv, hd = kc.shape
    n_t = S // page
    n_pages = 3 * b * n_t
    perm = torch.randperm(n_pages, generator=perm_gen, device=dev)[:b * n_t]
    kp = torch.randn((n_pages, page, Kv, hd), generator=perm_gen,
                     device=dev).to(kc.dtype)      # residue of other lanes
    vp = torch.randn((n_pages, page, Kv, hd), generator=perm_gen,
                     device=dev).to(kc.dtype)
    kp[perm] = kc.reshape(b * n_t, page, Kv, hd)
    vp[perm] = vc.reshape(b * n_t, page, Kv, hd)
    table = perm.to(torch.int32).reshape(b, n_t).clone()
    used = torch.arange(n_t, device=dev)[None, :] * page < lens[:, None]
    table[~used] = -1
    return kp, vp, table


def check_paged(torch, dev, *, b, Bq, Kv, G, hd, S, lens, dtype, page=32,
                softcap=None, window=None, timed=False, name=""):
    """The paged kernel against its plain version over a shuffled table with
    -1 tail entries, and bit for bit against the dense kernel on the same
    contents (identity table, then the shuffled one)."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attn import (
        decode_attention,
        paged_decode_attention,
    )
    from repro_torch.kernels.decode_attn import ref as dref
    dt = getattr(torch, dtype)
    g = torch.Generator(device=dev).manual_seed(len(name) + 7)
    rnd = lambda *s: torch.randn(s, generator=g, device=dev).to(dt)  # noqa
    q = rnd(b, Bq, Kv, G, hd)
    kc, vc = rnd(b, S, Kv, hd), rnd(b, S, Kv, hd)
    kb, vb = rnd(b, Bq, Kv, hd), rnd(b, Bq, Kv, hd)
    cl = torch.tensor(lens, dtype=torch.int32, device=dev)
    kw = dict(scale=hd ** -0.5, softcap=softcap, window=window)
    kp, vp, table = _paged_pool(torch, dev, kc, vc, cl, page, g)
    got = paged_decode_attention(q, kp, vp, kb, vb, table, cl, **kw)
    want = dref.paged_decode_attention(q, kp, vp, kb, vb, table, cl, **kw)
    dense = decode_attention(q, kc, vc, kb, vb, cl, **kw)
    ident = torch.arange(b * (S // page), dtype=torch.int32,
                         device=dev).reshape(b, S // page)
    same_ident = torch.equal(paged_decode_attention(
        q, kc.reshape(-1, page, Kv, hd), vc.reshape(-1, page, Kv, hd), kb,
        vb, ident, cl, **kw), dense)
    same_perm = torch.equal(got, dense)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    # both sides read the same inputs and accumulate in fp32
    tol = 1e-4
    if not err <= tol:
        raise AssertionError(f"paged_decode_attention {name}: max error "
                             f"{err} > {tol}")
    if not (same_ident and same_perm):
        raise AssertionError(f"paged_decode_attention {name}: not equal to "
                             f"the dense kernel bit for bit (identity "
                             f"{same_ident}, shuffled {same_perm})")
    rec = {"kernel": "paged_decode_attention", "case": name, "dtype": dtype,
           "shape": dict(b=b, Bq=Bq, Kv=Kv, G=G, hd=hd, page=page,
                         n_t=S // page, n_pages=kp.shape[0], lens=lens),
           "max_abs_err": err, "tol": tol,
           "bitwise_equal_dense": {"identity": same_ident,
                                   "shuffled": same_perm}}
    if timed:
        H, Lk = Kv * G, S + Bq
        qs = q.permute(0, 2, 3, 1, 4).reshape(b, H, Bq, hd)
        ks = torch.cat([kc, kb], 1).permute(0, 2, 1, 3).contiguous()
        vs = torch.cat([vc, vb], 1).permute(0, 2, 1, 3).contiguous()
        slot = torch.arange(Lk, device=dev)
        mask = ((slot[None, :] < cl[:, None]) | (slot[None, :] >= S))
        mask = mask[:, None, None, :].expand(b, 1, Bq, Lk)
        # the yardstick reads the gathered dense view (the gather untimed)
        library = (lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, scale=kw["scale"], enable_gqa=True))
        times = alternate(
            torch, lambda: dref.paged_decode_attention(q, kp, vp, kb, vb,
                                                       table, cl, **kw),
            lambda: paged_decode_attention(q, kp, vp, kb, vb, table, cl,
                                           **kw),
            library, iters=50)
        item = q.element_size()
        n_keys = sum(lens) + b * Bq
        n_bytes = (q.numel() * item + 2 * Kv * hd * item * sum(lens)
                   + (kb.numel() + vb.numel()) * item + got.numel() * 4
                   + 4 * b + 4 * sum(-(-n // page) for n in lens))
        n_ops = 4 * Kv * Bq * G * hd * n_keys
        bms, by = bound_ms(n_bytes, n_ops, dtype)
        rec.update(kernel_ms=times["kernel"], plain_ms=times["plain"],
                   library_ms=times["library"], bound_ms=bms, bound_by=by,
                   kernel_device_ms=device_ms(
                       torch, lambda: paged_decode_attention(
                           q, kp, vp, kb, vb, table, cl, **kw),
                       50, ["decode_attn_kernel"]))
    log(json.dumps(rec))
    return rec


def check_block(torch, dev, *, b, L, Kv, G, hd, dtype, mode, prompt_len=0,
                block_size=1, window=None, softcap=None, timed=False,
                name=""):
    """The block attention kernel against its plain version (both keep
    scores and probabilities in fp32)."""
    import torch.nn.functional as F

    from repro_torch.kernels.block_attn import flash_block_attention
    from repro_torch.kernels.block_attn import ref as bref
    dt = getattr(torch, dtype)
    g = torch.Generator(device=dev).manual_seed(len(name) + L)
    rnd = lambda *s: torch.randn(s, generator=g, device=dev).to(dt)  # noqa
    q = rnd(b, L, Kv, G, hd)
    k, v = rnd(b, L, Kv, hd), rnd(b, L, Kv, hd)
    kw = dict(mode=mode, prompt_len=prompt_len, block_size=block_size,
              window=window, scale=hd ** -0.5, softcap=softcap)
    got = flash_block_attention(q, k, v, **kw)
    want = bref.block_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    tol = 1e-4
    if not err <= tol:
        raise AssertionError(f"block_attention {name}: max error {err} > "
                             f"{tol}")
    rec = {"kernel": "block_attention", "case": name, "dtype": dtype,
           "shape": dict(b=b, L=L, Kv=Kv, G=G, hd=hd, mode=mode,
                         prompt_len=prompt_len, block_size=block_size,
                         window=window, softcap=softcap),
           "max_abs_err": err, "tol": tol}
    if timed:
        vis = bref.visibility(L, L, mode=mode, prompt_len=prompt_len,
                              block_size=block_size, window=window,
                              device=dev)
        qs = q.permute(0, 2, 3, 1, 4).reshape(b, Kv * G, L, hd)
        ks = k.permute(0, 2, 1, 3).contiguous()
        vs = v.permute(0, 2, 1, 3).contiguous()
        library = (lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=vis, scale=kw["scale"], enable_gqa=True))
        times = alternate(
            torch, lambda: bref.block_attention(q, k, v, **kw),
            lambda: flash_block_attention(q, k, v, **kw), library, iters=10)
        item = q.element_size()
        n_bytes = (q.numel() + k.numel() + v.numel()) * item + got.numel() * 4
        n_ops = 4 * hd * int(vis.sum()) * b * Kv * G
        bms, by = bound_ms(n_bytes, n_ops, dtype)
        rec.update(kernel_ms=times["kernel"], plain_ms=times["plain"],
                   library_ms=times["library"], bound_ms=bms, bound_by=by,
                   visible_pairs=int(vis.sum()),
                   kernel_device_ms=device_ms(
                       torch, lambda: flash_block_attention(q, k, v, **kw),
                       10, ["block_attn_kernel"]))
    log(json.dumps(rec))
    return rec


U32 = 2.0 ** -24                          # fp32 unit roundoff


def select_limits(torch, h, w, cand, V):
    """Per-row limits for comparing two fp32 evaluations of the selection,
    set from the rounding error of logits of this size.

    Each logit is a sum of d products, accumulated in fp32 one term after
    the other (the kernel's fma chain; cuBLAS sums in blocks, with less
    error). Rounding the partial sum s_k costs at most u |s_k|; taken as
    independent and uniform, the logit is off by a standard deviation of
    sigma = u / sqrt(3) * R with R = sqrt(sum_k s_k^2), here R of the row's
    top logit. log(conf) = z_top - logsumexp(z) moves by at most two such
    terms, and the sum-exp over the vocabulary adds at most
    u / sqrt(3) * sqrt(V / 64) (at most one rounding per 64-wide vocab
    tile, chained). Two sides (kernel and plain) give sqrt(2); the limit
    is six standard deviations:
        conf_rel_t = 6 sqrt(2) u / sqrt(3) (2 R_t + sqrt(V / 64)).
    The top-2 gap of two logits moves by at most 6 * 2 sigma, so a row
    whose gap is below max(NEAR_TIE, that) may pick either candidate.
    """
    part = torch.cumsum(h.double() * w[cand.long()].double(), dim=-1)
    R = part.square().sum(-1).sqrt()
    sig = U32 / 3 ** 0.5
    conf_rel = 6 * 2 ** 0.5 * sig * (2 * R + (V / 64) ** 0.5)
    gap = torch.clamp(6 * 2 * sig * R, min=NEAR_TIE)
    return conf_rel.float(), gap.float()


def check_select(torch, dev, *, T, d, V, dtype, scale, timed=False,
                 name=""):
    """``scale`` sets W's spread: at 0.02 the logits spread about 0.6 and
    confidences sit near 1/V (as at random init); at 1 they spread about
    sqrt(d) and most rows are near-certain, as in a trained model, where
    threshold finalization and the confidence comparison bite."""
    from repro_torch.kernels.select import fused_select
    from repro_torch.kernels.select import ref as sref
    dt = getattr(torch, dtype)
    g = torch.Generator(device=dev).manual_seed(V % 1000)
    h = torch.randn((T, d), generator=g, device=dev).to(dt)
    w = (torch.randn((V, d), generator=g, device=dev) * scale).to(dt)
    masked = torch.rand((T,), generator=g, device=dev) < 0.7
    # a planted tie across vocab chunks: rows 1 and V-7 are equal and are
    # row 0's maximum (a logit near 0.4 d scale, far above the spread); the
    # lower index must win
    w[1] = w[V - 7] = (h[0].float().sign() * scale / 2).to(dt)
    got_c, got_f = fused_select(h, w, masked)
    want_c, want_f = sref.select_streaming(h, w, masked)
    logits = h.float() @ w.float().t()
    top2 = logits.topk(2, dim=-1).values
    del logits
    conf_tol, gap_tol = select_limits(torch, h, w, got_c, V)
    gap = (top2[:, 0] - top2[:, 1]).cpu()
    torch.cuda.synchronize()
    diff = (got_c != want_c).cpu()
    ties = [(int(t), float(gap[t])) for t in diff.nonzero().flatten()]
    for t, gp in ties:
        log(f"select {name}: row {t} kernel cand {int(got_c[t])} != plain "
            f"{int(want_c[t])} at a top-2 logit gap of {gp} (limit "
            f"{float(gap_tol[t])})")
    if any(gp >= float(gap_tol[t]) for t, gp in ties):
        raise AssertionError(f"select {name}: candidates differ away from "
                             "a near-tie")
    if int(got_c[0]) != 1:
        raise AssertionError(f"select {name}: planted tie gave "
                             f"{int(got_c[0])}, expected 1")
    fin = torch.isfinite(want_f)
    if not torch.equal(fin, masked) or not torch.equal(
            torch.isfinite(got_f), masked):
        raise AssertionError(f"select {name}: finalized rows not -inf")
    same = fin & ~diff.to(dev)
    rel_t = (got_f - want_f).abs() / want_f.abs()
    if not bool((rel_t[same] <= conf_tol[same]).all()):
        worst = int(torch.where(same, rel_t / conf_tol, 0).argmax())
        raise AssertionError(
            f"select {name}: conf relative error {float(rel_t[worst])} > "
            f"limit {float(conf_tol[worst])} at row {worst}")
    rel = rel_t[same].max().item()
    err = (got_f - want_f).abs()[same].max().item()
    conf = want_f[fin]
    rec = {"kernel": "fused_select", "case": name, "dtype": dtype,
           "shape": dict(T=T, d=d, V=V, w_scale=scale), "max_abs_err": err,
           "max_rel_err": rel,
           "rel_limit": [conf_tol[same].min().item(),
                         conf_tol[same].max().item()],
           "worst_share_of_limit": (rel_t / conf_tol)[same].max().item(),
           "conf_median": conf.median().item(),
           "conf_ge_0.9": (conf >= 0.9).float().mean().item(),
           "near_ties": ties}
    if timed:
        library = lambda: torch.softmax((h @ w.t()).float(), -1).max(-1)  # noqa
        times = alternate(torch, lambda: sref.select_streaming(h, w, masked),
                          lambda: fused_select(h, w, masked), library,
                          iters=5)
        item = h.element_size()
        bms, by = bound_ms((T * d + V * d) * item + 4 * T + 8 * T,
                           2 * T * V * d, dtype)
        rec.update(kernel_ms=times["kernel"], plain_ms=times["plain"],
                   library_ms=times["library"], bound_ms=bms, bound_by=by,
                   kernel_device_ms=device_ms(
                       torch, lambda: fused_select(h, w, masked), 5,
                       ["select_partial_kernel", "select_merge_kernel"]))
    log(json.dumps(rec))
    return rec


def phase_kernels(torch, dev):
    lens8 = [0, 512, 536, 577, 608, 640, 700, 736]
    main = {}
    for name, kv, hd in (("qwen2-0.5b", 2, 64), ("dream-7b", 4, 128)):
        for dtype in ("bfloat16", "float32"):
            rec = check_decode(torch, dev, b=8, Bq=32, Kv=kv, G=7, hd=hd,
                               S=768, lens=lens8, dtype=dtype, timed=True,
                               name=f"{name}/{dtype}")
            prec = check_paged(torch, dev, b=8, Bq=32, Kv=kv, G=7, hd=hd,
                               S=768, lens=lens8, dtype=dtype, timed=True,
                               name=f"{name}/{dtype}")
            if name == "qwen2-0.5b" and dtype == "bfloat16":
                main["decode_attention"] = rec
                main["paged_decode_attention"] = prec
    small = dict(b=2, Bq=8, Kv=2, G=2, hd=64, S=64, lens=[5, 40])
    for check in (check_decode, check_paged):
        check(torch, dev, **small, dtype="float32", softcap=5.0,
              name="softcap")
        check(torch, dev, **small, dtype="float32", window=6, name="window")
        check(torch, dev, **small, dtype="bfloat16", softcap=5.0, window=6,
              name="softcap+window")
    check_paged(torch, dev, **dict(small, S=60), dtype="float32", page=5,
                window=9, name="page 5")
    # the prefill of every admission: 8 lanes of a 512-token prompt, all
    # of it block -1, so every key is visible
    prefill = dict(b=8, L=512, G=7, dtype="bfloat16", mode="block_causal",
                   prompt_len=512, block_size=32, timed=True)
    main["block_attention"] = check_block(torch, dev, Kv=2, hd=64, **prefill,
                                          name="qwen2-0.5b prefill")
    check_block(torch, dev, Kv=4, hd=128, **prefill, name="dream-7b prefill")
    small = dict(b=2, Kv=2, G=3, hd=64, dtype="float32")
    check_block(torch, dev, L=100, mode="causal", **small, name="causal")
    check_block(torch, dev, L=77, mode="bidirectional", **small,
                name="bidirectional ragged")
    check_block(torch, dev, L=90, mode="block_causal", prompt_len=40,
                block_size=16, **small, name="block_causal P<L ragged")
    check_block(torch, dev, L=96, mode="block_causal", prompt_len=32,
                block_size=16, window=20, **small, name="window")
    check_block(torch, dev, L=64, mode="causal", softcap=3.0, window=9,
                **small, name="causal softcap+window")
    check_block(torch, dev, b=2, L=70, Kv=2, G=7, hd=128, dtype="bfloat16",
                mode="bidirectional", softcap=5.0, name="bf16 softcap")
    main["fused_select"] = check_select(
        torch, dev, T=256, d=896, V=151_936, dtype="bfloat16", scale=0.02,
        timed=True, name="qwen2-0.5b tied")
    check_select(torch, dev, T=256, d=3584, V=152_064, dtype="bfloat16",
                 scale=0.02, timed=True, name="dream-7b untied")
    check_select(torch, dev, T=256, d=896, V=151_936, dtype="float32",
                 scale=0.02, name="qwen2-0.5b fp32")
    for dtype in ("bfloat16", "float32"):
        check_select(torch, dev, T=256, d=896, V=151_936, dtype=dtype,
                     scale=1.0, name=f"qwen2-0.5b sharp {dtype}")
    return main


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------
def _random_params(torch, cfg, dev, dtype):
    from repro_torch.bridge import init_params
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev,
                         dtype)
    # a zero mask-token row: as in a trained model, the mask token is never
    # a candidate, so every returned span holds real tokens
    params["embed"]["tok"][cfg.mask_token_id] = 0
    return params


def kernel_wrappers():
    from repro_torch.kernels.block_attn import flash_block_attention
    from repro_torch.kernels.decode_attn import (
        decode_attention,
        paged_decode_attention,
    )
    from repro_torch.kernels.select import fused_select
    return {"decode_attention": decode_attention,
            "fused_select": fused_select,
            "paged_decode_attention": paged_decode_attention,
            "block_attention": flash_block_attention}


def serve_counted(torch, dev, eng, reqs):
    """``eng.generate(reqs)`` with every kernel's launch count set to 0 just
    before and read just after. Returns (outputs by id, wall s, launches)."""
    fns = kernel_wrappers()
    for fn in fns.values():
        fn.launches = 0
    t0 = time.perf_counter()
    outs = eng.generate(reqs)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in fns.items()}
    return {o.id: o for o in outs}, wall, launches


def check_launches(cfg, calls, launches, layout):
    """Each kernel launched exactly as often as the engine's call accounting
    says: select once per refinement iteration, block attention once per
    layer and admission, the layout's decode attention once per layer and
    cached forward, the other layout's never."""
    cached = cfg.n_layers * (calls["refine"] + calls["commit"])
    want = {"decode_attention": cached if layout == "dense" else 0,
            "fused_select": calls["refine"],
            "paged_decode_attention": cached if layout == "paged" else 0,
            "block_attention": cfg.n_layers * calls["admit"]}
    if launches != want:
        raise AssertionError(f"{layout}: launches {launches} != the call "
                             f"accounting {want} ({calls})")


def check_outputs(cfg, outs, caps, B):
    if sorted(outs) != sorted(caps):
        raise AssertionError("not every request completed")
    for rid, o in outs.items():
        cap = caps[rid]
        if np.any(o.tokens == cfg.mask_token_id):
            raise AssertionError(f"request {rid}: mask token left")
        n_blocks = -(-cap // B)
        if not (1 <= o.steps <= n_blocks * B and o.gen_length <= cap):
            raise AssertionError(f"request {rid}: steps {o.steps} / "
                                 f"gen_length {o.gen_length} out of bounds")


def phase_serving(torch, dev):
    from repro_torch.configs import ServeConfig, get_config
    from repro_torch.serving import ContinuousEngine, Request

    cfg = get_config("qwen2-0.5b")
    P, B, G = 512, 32, 256
    params = _random_params(torch, cfg, dev, "bfloat16")
    serve = ServeConfig(max_batch=8, block_size=B, gen_length=G,
                        conf_threshold=0.9, scheduler="continuous",
                        fused_select=True)
    eng = ContinuousEngine(params, cfg, serve, prompt_len=P, device=dev)
    eng.warmup()
    rng = np.random.default_rng(0)
    caps = [256, 64, 128, 32, 96, 256, 32, 160, 64, 224, 128, 32]
    prompts = rng.integers(0, cfg.mask_token_id, (len(caps), P))
    reqs = [Request(prompt=p, id=i, max_tokens=c)
            for i, (p, c) in enumerate(zip(prompts, caps))]
    torch.cuda.reset_peak_memory_stats(dev)
    outs, wall, launches = serve_counted(torch, dev, eng, reqs)
    calls = eng.call_counts()
    check_outputs(cfg, outs, dict(enumerate(caps)), B)
    check_launches(cfg, calls, launches, "dense")
    tokens = sum(o.gen_length for o in outs.values())
    rec = {"phase": "serving", "config": "qwen2-0.5b", "dtype": "bfloat16",
           "layout": "dense", "requests": len(outs), "max_batch": 8,
           "block": B, "gen": G, "prompt_len": P, "tau": 0.9,
           "tokens": tokens, "wall_s": wall, "tps": tokens / wall,
           "mean_latency_s": float(np.mean([o.latency_s
                                            for o in outs.values()])),
           "mean_steps": float(np.mean([o.steps for o in outs.values()])),
           "calls": calls, "launches": launches,
           "concurrency": eng.concurrency_stats(),
           "max_memory_allocated_bytes":
               torch.cuda.max_memory_allocated(dev)}
    log(json.dumps(rec))
    log(json.dumps(profile_block(torch, dev, eng, prompts[:8], B)))
    return {"cfg": cfg, "params": params, "serve": serve, "P": P, "B": B,
            "caps": caps, "prompts": prompts, "outs": outs,
            "launches": launches}


def phase_paged(torch, dev, ctx):
    """The dense phase's trace on the paged layout: a dense-equivalent pool
    (8 x 24 pages), then a tight one (40 pages, the first 8 requests) that
    stalls and preempts. The layouts run bit-identical arithmetic per lane
    (the paged kernel equals the dense one bit for bit, and a lane's rows
    never meet another lane's), so tokens must equal the dense run's
    exactly."""
    import dataclasses

    from repro_torch.serving import ContinuousEngine, Request
    cfg, P, B = ctx["cfg"], ctx["P"], ctx["B"]
    caps, prompts = ctx["caps"], ctx["prompts"]
    launches = {}
    for case, pool, n_req in (("dense-equivalent", None, len(caps)),
                              ("tight", 40, 8)):
        serve = dataclasses.replace(ctx["serve"], cache_layout="paged",
                                    page_pool_pages=pool)
        eng = ContinuousEngine(ctx["params"], cfg, serve, prompt_len=P,
                               device=dev)
        eng.warmup()
        reqs = [Request(prompt=prompts[i], id=i, max_tokens=caps[i])
                for i in range(n_req)]
        outs, wall, counts = serve_counted(torch, dev, eng, reqs)
        calls = eng.call_counts()
        check_outputs(cfg, outs, {i: caps[i] for i in range(n_req)}, B)
        check_launches(cfg, calls, counts, "paged")
        for rid, o in outs.items():
            want = ctx["outs"][rid]
            if not (np.array_equal(o.tokens, want.tokens)
                    and o.steps == want.steps):
                diff = np.flatnonzero(o.tokens != want.tokens)
                raise AssertionError(
                    f"paged {case}: request {rid} differs from the dense "
                    f"layout (steps {o.steps} vs {want.steps}, first token "
                    f"positions {diff[:5].tolist()})")
        stats = eng.page_pool_stats()
        accounting = eng.page_accounting()
        if accounting != (eng.n_pages, eng.n_pages):
            raise AssertionError(f"paged {case}: pool not fully free at the "
                                 f"end: {accounting} of {eng.n_pages}")
        if pool is not None and not (stats["stall_rounds"] >= 1
                                     and stats["preemptions"] >= 1):
            raise AssertionError(f"paged {case}: no stall or no preemption "
                                 f"{stats}")
        tokens = sum(o.gen_length for o in outs.values())
        log(json.dumps({
            "phase": "paged serving", "case": case, "config": "qwen2-0.5b",
            "dtype": "bfloat16", "requests": len(outs), "tokens": tokens,
            "wall_s": wall, "tps": tokens / wall, "calls": calls,
            "launches": counts, "page_pool_stats": stats,
            "concurrency": eng.concurrency_stats(),
            "page_accounting": accounting, "tokens_equal_dense": True}))
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
    return launches


def profile_block(torch, dev, eng, prompts, B):
    """Where the time goes: 8 one-block requests (one admission, 32
    refinement iterations, one commit pass) under the profiler; device time
    by kernel, grouped, and the share of the wall time the device was
    busy."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving import Request
    reqs = [Request(prompt=p, id=1000 + i, max_tokens=B)
            for i, p in enumerate(prompts)]
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng.generate(reqs)
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    by_kernel = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if us:
            by_kernel[ev.key] = (us / 1e3, ev.count)
    groups = {"decode_attention": 0.0, "block_attention": 0.0,
              "fused_select": 0.0, "matmul": 0.0, "other": 0.0}
    for key, (ms, _) in by_kernel.items():
        if "decode_attn" in key:
            groups["decode_attention"] += ms
        elif "block_attn" in key:
            groups["block_attention"] += ms
        elif "select_" in key:
            groups["fused_select"] += ms
        elif any(s in key.lower() for s in ("gemm", "cutlass", "xmma",
                                            "nvjet", "sm90")):
            groups["matmul"] += ms
        else:
            groups["other"] += ms
    busy = sum(groups.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:10]
    return {"phase": "profile", "requests": len(reqs), "wall_ms": wall * 1e3,
            "device_busy_ms": busy, "idle_share": 1 - busy / (wall * 1e3),
            "device_ms_by_group": groups, "calls": eng.call_counts(),
            "top_kernels": [{"name": k[:120], "ms": ms, "count": n}
                            for k, (ms, n) in top]}


# ---------------------------------------------------------------------------
# phase 4: kernel path against plain path
# ---------------------------------------------------------------------------
def phase_paths(torch, dev):
    from repro_torch.configs import get_config
    from repro_torch.core import cache as C
    from repro_torch.core import diffusion as D
    from repro_torch.core import masks
    from repro_torch.core.block_loop import (
        SamplerSpec,
        init_canvas,
        lane_block_forward,
    )
    from repro_torch.kernels.block_attn import flash_block_attention
    from repro_torch.kernels.block_attn import ref as bref
    from repro_torch.kernels.decode_attn import (
        decode_attention,
        paged_decode_attention,
    )
    from repro_torch.kernels.decode_attn import ref as dref
    from repro_torch.kernels.select import fused_select
    from repro_torch.kernels.select import ref as sref
    from repro_torch.models import forward, unembed_matrix

    cfg = get_config("qwen2-0.5b")
    P, B, tau = 128, 32, 0.9
    params = _random_params(torch, cfg, dev, "float32")
    spec = SamplerSpec(prompt_len=P, gen_len=B, block_size=B,
                       conf_threshold=tau)
    rng = np.random.default_rng(1)
    prompts = torch.as_tensor(rng.integers(0, cfg.mask_token_id, (2, P)),
                              device=dev)
    rows = np.ones((2,), bool)

    def prefill(attn):
        return forward(params, prompts, cfg=cfg, device=dev,
                       mode=masks.BLOCK_CAUSAL, prompt_len=P, block_size=B,
                       return_logits=False,
                       prefill_attention_fn=attn).emissions

    em_kernel, em_plain = prefill(flash_block_attention), prefill(
        bref.block_attention)
    prefill_err = max((a[k] - b[k]).abs().max().item()
                      for a, b in zip(em_kernel, em_plain) for k in a)
    dense_k = C.commit_rows(C.init_cache(cfg, 2, P + B, dtype="float32",
                                         device=dev), em_kernel, 0, rows)
    dense_p = C.commit_rows(C.init_cache(cfg, 2, P + B, dtype="float32",
                                         device=dev), em_plain, 0, rows)
    # the paged cache: lane 1's pages first and reversed, spare pages
    paged = C.init_paged_cache(cfg, 2, P + B, n_pages=3 * (P + B) // B,
                               page_size=B, dtype="float32", device=dev)
    C.alloc(paged, np.array([False, True]), 0, P)
    paged.page_table[1, :P // B] = paged.page_table[1, :P // B][::-1].copy()
    C.alloc(paged, np.array([True, False]), 0, P)
    paged.touch()
    C.commit_rows(paged, em_kernel, 0, rows)
    tokens = init_canvas(prompts, spec, cfg)
    starts = [P, P]
    w = unembed_matrix(params, cfg)
    all_block = torch.ones((1, B), dtype=torch.bool, device=dev)

    def plain_select(h, w, masked):
        c, f = sref.select_streaming(h.reshape(-1, h.shape[-1]), w,
                                     masked.reshape(-1))
        return c.reshape(masked.shape), f.reshape(masked.shape)

    # each path's attention goes to both decode hooks; the cache's layout
    # picks the one that runs
    paths = {"kernel": (dense_k, decode_attention, fused_select),
             "paged": (paged, paged_decode_attention, fused_select),
             "plain": (dense_p, dref.decode_attention, plain_select)}
    iters, divergence = 0, None
    while iters < B:
        bt = tokens[:, P:P + B]
        if not (bt == cfg.mask_token_id).any():
            break
        res = {}
        for name, (cache, attn, select) in paths.items():
            h, _ = lane_block_forward(params, tokens, starts, cache, cfg=cfg,
                                      spec=spec, return_hidden=True,
                                      decode_attention_fn=attn,
                                      paged_decode_attention_fn=attn)
            cand, conf = select(h, w, bt == cfg.mask_token_id)
            sel = D.select_threshold_in_block(conf, all_block, tau)
            res[name] = (h, cand, conf, sel,
                         torch.where(sel, cand.to(bt.dtype), bt))
        if not all(torch.equal(a, b) for a, b in zip(res["paged"],
                                                      res["kernel"])):
            raise AssertionError(f"iteration {iters}: the paged kernel path "
                                 "differs from the dense kernel path")
        if not torch.equal(res["kernel"][4], res["plain"][4]):
            h, cand, conf, sel, _ = res["plain"]
            kc, ksel, kconf = res["kernel"][1], res["kernel"][3], \
                res["kernel"][2]
            if not torch.equal(sel, ksel):   # another position was chosen
                lane = int((sel != ksel).any(-1).nonzero()[0])
                a, b_ = int(sel[lane].float().argmax()), \
                    int(ksel[lane].float().argmax())
                gap = abs(float(conf[lane, a] - conf[lane, b_])) / float(
                    conf[lane, a])
                kind = "relative confidence gap"
            else:                            # another token at one position
                lane, pos = [int(x) for x in
                             ((cand != kc) & sel).nonzero()[0]]
                top2 = (h[lane, pos].float() @ w.float().t()).topk(2).values
                gap = float(top2[0] - top2[1])
                kind = "top-2 logit gap"
            divergence = {"iteration": iters, "lane": lane, "kind": kind,
                          "gap": gap}
            log(f"paths diverge at iteration {iters}, lane {lane}: {kind} "
                f"{gap}")
            if gap >= NEAR_TIE:
                raise AssertionError("kernel and plain paths diverge away "
                                     "from a near-tie")
            break
        tokens[:, P:P + B] = res["kernel"][4]
        iters += 1
    log(json.dumps({"phase": "paths", "config": "qwen2-0.5b",
                    "dtype": "float32", "iterations_compared": iters,
                    "prefill_emissions_max_abs_diff": prefill_err,
                    "paged_equals_dense_kernel_path": True,
                    "equal": divergence is None,
                    "divergence": divergence}))


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build   # fails outside a checkout

    dev = torch.device("cuda", 0)
    t_all = time.perf_counter()
    t = time.perf_counter()
    smi = nvidia_smi()
    log(f"card: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    _build.build(verbose=True)
    log(f"phase 1 (card, build): {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    main_recs = phase_kernels(torch, dev)
    log(f"phase 2 (kernels vs plain): {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    ctx = phase_serving(torch, dev)
    log(f"phase 3 (serving, dense): {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    paged_launches = phase_paged(torch, dev, ctx)
    log(f"phase 3b (serving, paged): {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    phase_paths(torch, dev)
    log(f"phase 4 (kernel vs plain path): {time.perf_counter() - t:.1f} s")
    log(f"total: {time.perf_counter() - t_all:.1f} s")

    # launches: summed over the main-path runs (phase 3 and both runs of
    # phase 3b), each counted from 0
    sources = {"decode_attention": (DECODE_SRC, DECODE_TPU),
               "fused_select": (SELECT_SRC, SELECT_TPU),
               "paged_decode_attention": (DECODE_SRC, PAGED_TPU),
               "block_attention": (BLOCK_SRC, BLOCK_TPU)}
    summary = []
    for name in KERNELS:
        rec = main_recs[name]
        launches = ctx["launches"][name] + paged_launches[name]
        if launches == 0:
            raise AssertionError(f"{name}: never launched on the main path")
        src, tpu = sources[name]
        summary.append({
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "launches": launches, "max_abs_err": rec["max_abs_err"],
            "ms": rec["kernel_ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"]})
    log(json.dumps({"kernels": summary}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
