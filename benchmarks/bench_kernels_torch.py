"""Kernel-layer microbenchmarks of the port on the card, the counterpart of
``benchmarks/bench_kernels.py``:

- attention: the dense and paged decode attention kernels (a CDLM block of
  32 queries a lane against 8 lanes' caches of 512..736 rows) and the block
  attention kernel (the admission prefill, 8 lanes of 512 prompt tokens) at
  qwen2-0.5b's, dream-7b's and llada-8b's head layouts, bf16;
- select: the decode iteration's vocabulary cost at 8 lanes x 32 rows and
  qwen2-0.5b's width, V in {32,768, 131,072, 151,936}: the dense selection
  (the lm_head logits, an fp32 softmax, argmax and gather) against
  ``fused_select`` called with no knobs, so the timed launch is the one the
  tuned table resolves, as the serving loop gets it.

Every row holds the kernel's CUDA-event time per eager call and through a
CUDA graph of its calls (the device's time, as the engines' graphs replay
it), its plain version's eager time, one library call's (masked SDPA; the
dense selection) eager and through a graph, and the bound on an H100
(``repro_torch.configs.H100``: the larger of the bytes over HBM bytes/s and
the operations over the dtype's peak), with the knobs the wrapper resolved
("built-in" where the table has no entry). The bench makes no launch of
its own: every kernel runs through its wrapper.

``--tune [--tune-ops OP,...] [--confirm PRIOR.json]`` first runs
``tuning.run_sweep`` on the card (every candidate timed; the log goes to
the ``--json`` file's ``sweep``), writes
``src/repro_torch/kernels/tuned_configs_cuda.json``, then benches with the
new table. Alone it writes the candidates that beat the built-in rule by
more than ``tuning.SWEEP_MARGIN`` in this sweep; with ``--confirm`` (the
``--json`` file of an earlier ``--tune`` run, best from another process on
another machine) only those that beat it in both sweeps by more than the
rule's own spread between them. ``--tune`` refuses ``--smoke``: a table is
written from full sweeps only. On the CPU (``--device cpu``) only the
shapes, bounds and resolved knobs are printed: a kernel time is measured on
the card or not at all.

    python3 benchmarks/bench_kernels_torch.py                  # the card
    python3 benchmarks/bench_kernels_torch.py --tune --json a.json
    python3 benchmarks/bench_kernels_torch.py --tune --confirm a.json \
        --json b.json                         # in another process
    python3 benchmarks/bench_kernels_torch.py --device cpu --smoke

Imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from benchmarks import common_torch as common  # noqa: E402

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch import resolve_device  # noqa: E402
from repro_torch.kernels import tuning  # noqa: E402
from repro_torch.kernels.block_attn import flash_block_attention  # noqa: E402
from repro_torch.kernels.block_attn import ref as bref  # noqa: E402
from repro_torch.kernels.decode_attn import (  # noqa: E402
    decode_attention,
    paged_decode_attention,
)
from repro_torch.kernels.decode_attn import ref as dref  # noqa: E402
from repro_torch.kernels.select import fused_select  # noqa: E402
from repro_torch.kernels.select import ref as sref  # noqa: E402
from repro_torch.roofline import bound_ms  # noqa: E402

SELECT_VOCABS = tuning.SELECT_VOCABS
HEADS = tuning.DECODE_SHAPES          # (config, Kv, G, hd)
LENS = [512, 536, 577, 608, 640, 672, 700, 736]


def _ms(dev, fn, iters, graph=False):
    """ms per call on the card by CUDA events (``tuning.time_us``): eager
    back-to-back calls, or a CUDA graph of them replayed (the device's
    time); None (not measured) off the card."""
    if dev.type != "cuda":
        return None
    return tuning.time_us(fn, iters=iters, graph=graph) / 1e3


def _row(records, op, shape, dev, knobs, tuned, kernel, plain, library,
         bound, iters):
    """Time the three sides eagerly (kernel, plain, library, then again in
    reverse), and the kernel and the library call through a CUDA graph of
    their calls; one record per number, plus the bound. ``knobs``: what the
    wrapper resolves; ``tuned``: whether the table set them."""
    times = {}
    for side, fn in (("kernel", kernel), ("plain", plain),
                     ("library", library), ("library", library),
                     ("plain", plain), ("kernel", kernel)):
        t = _ms(dev, fn, iters)
        if t is not None:
            times.setdefault(side, []).append(t)
    ms = {k: sum(v) / len(v) for k, v in times.items()}
    for side, fn in (("kernel", kernel), ("library", library)):
        t = _ms(dev, fn, iters, graph=True)
        if t is not None:
            ms[f"{side}_graph"] = t
    bms, by = bound
    cfg = knobs.to_dict()
    table = "tuned" if tuned else "built-in"
    print(f"  {op:22s} {str(shape):58s} kernel {_fmt(ms.get('kernel'))} "
          f"(graph {_fmt(ms.get('kernel_graph'))}) plain "
          f"{_fmt(ms.get('plain'))} library {_fmt(ms.get('library'))} "
          f"(graph {_fmt(ms.get('library_graph'))}) bound {bms:.4f} ({by}) "
          f"{table} {cfg or ''}", flush=True)
    for side in ("kernel", "kernel_graph", "plain", "library",
                 "library_graph"):
        if side in ms:
            records.append(common.record(op, shape, f"{side}_ms", ms[side],
                                         device=dev, config=cfg))
    records.append(common.record(op, shape, "bound_ms", bms, device=dev,
                                 config=dict(cfg, bound_by=by)))
    return {**ms, "bound_ms": bms, "bound_by": by, "config": cfg,
            "table": table}


def _fmt(x):
    return "not measured" if x is None else f"{x:.4f} ms"


def _knobs(op, dev, **shape):
    """The knobs the wrapper resolves, and whether the table set them."""
    name = tuning.backend(dev)
    got = tuning.resolve(op, backend_name=name, **shape)
    tuned = tuning.lookup(op, tuning.bucket_for(op, **shape),
                          backend_name=name)
    return got, tuned


def run_attention(records, dev, smoke=False):
    print(f"\n== kernel-layer microbench: attention ({dev}, bf16) ==")
    iters = 10 if smoke else 50
    b, Bq, S, dt = 8, 32, 768, torch.bfloat16
    rows = {}
    for name, Kv, G, hd in (HEADS[:1] if smoke else HEADS):
        g = torch.Generator(device=dev).manual_seed(Kv * hd)
        rnd = lambda *s: torch.randn(s, generator=g, device=dev).to(dt)  # noqa
        q = rnd(b, Bq, Kv, G, hd)
        kc, vc = rnd(b, S, Kv, hd), rnd(b, S, Kv, hd)
        kb, vb = rnd(b, Bq, Kv, hd), rnd(b, Bq, Kv, hd)
        cl = torch.tensor(LENS, dtype=torch.int32, device=dev)
        scale = hd ** -0.5
        page = 32
        kp, vp = kc.reshape(-1, page, Kv, hd), vc.reshape(-1, page, Kv, hd)
        table = torch.arange(b * S // page, dtype=torch.int32,
                             device=dev).reshape(b, S // page)
        # the library: masked SDPA over the cache and the block's keys
        Lk = S + Bq
        qs = q.permute(0, 2, 3, 1, 4).reshape(b, Kv * G, Bq, hd)
        ks = torch.cat([kc, kb], 1).permute(0, 2, 1, 3).contiguous()
        vs = torch.cat([vc, vb], 1).permute(0, 2, 1, 3).contiguous()
        slot = torch.arange(Lk, device=dev)
        mask = ((slot[None, :] < cl[:, None]) | (slot[None, :] >= S))
        mask = mask[:, None, None, :].expand(b, 1, Bq, Lk)
        library = (lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, scale=scale, enable_gqa=True))
        knobs, tuned = _knobs("decode_attn", dev, Kv=Kv, rows=Bq * G)
        item = q.element_size()
        n_bytes = (q.numel() * item + 2 * Kv * hd * item * sum(LENS)
                   + (kb.numel() + vb.numel()) * item + q.numel() * 4
                   + 4 * b)
        n_ops = 4 * Kv * Bq * G * hd * (sum(LENS) + b * Bq)
        shape = dict(model=name, b=b, Bq=Bq, Kv=Kv, G=G, hd=hd, S=S)
        r = _row(records, "decode_attention", shape, dev, knobs, tuned,
                 lambda: decode_attention(q, kc, vc, kb, vb, cl, scale=scale),
                 lambda: dref.decode_attention(q, kc, vc, kb, vb, cl,
                                               scale=scale),
                 library, bound_ms(n_bytes, n_ops, "bfloat16"), iters)
        rows[f"decode_attention/{name}"] = r
        r = _row(records, "paged_decode_attention", dict(shape, page=page),
                 dev, knobs, tuned,
                 lambda: paged_decode_attention(q, kp, vp, kb, vb, table, cl,
                                                scale=scale),
                 lambda: dref.paged_decode_attention(q, kp, vp, kb, vb, table,
                                                     cl, scale=scale),
                 library, bound_ms(n_bytes + 4 * table.numel(), n_ops,
                                   "bfloat16"),
                 iters)
        rows[f"paged_decode_attention/{name}"] = r
        # the admission prefill: every key of the prompt visible
        L = 128 if smoke else 512
        qp = rnd(b, L, Kv, G, hd)
        kpf, vpf = rnd(b, L, Kv, hd), rnd(b, L, Kv, hd)
        kw = dict(mode="block_causal", prompt_len=L, block_size=32,
                  scale=scale)
        vis = bref.visibility(L, L, mode="block_causal", prompt_len=L,
                              block_size=32, window=None, device=dev)
        qps = qp.permute(0, 2, 3, 1, 4).reshape(b, Kv * G, L, hd)
        kps = kpf.permute(0, 2, 1, 3).contiguous()
        vps = vpf.permute(0, 2, 1, 3).contiguous()
        n_bytes = (qp.numel() + kpf.numel() + vpf.numel()) * item \
            + qp.numel() * 4
        n_ops = 4 * hd * int(vis.sum()) * b * Kv * G
        r = _row(records, "block_attention",
                 dict(model=name, b=b, L=L, Kv=Kv, G=G, hd=hd,
                      mode="prefill"), dev, tuning.KernelConfig(), None,
                 lambda: flash_block_attention(qp, kpf, vpf, **kw),
                 lambda: bref.block_attention(qp, kpf, vpf, **kw),
                 lambda: F.scaled_dot_product_attention(
                     qps, kps, vps, attn_mask=vis, scale=scale,
                     enable_gqa=True),
                 bound_ms(n_bytes, n_ops, "bfloat16"), max(1, iters // 5))
        rows[f"block_attention/{name}"] = r
    return rows


def run_select(records, dev, smoke=False):
    """The dense selection against ``fused_select`` with no knobs."""
    T, d = (64, 256) if smoke else (tuning.SELECT_SHAPE["T"],
                                    tuning.SELECT_SHAPE["d"])
    vocabs = (32_768,) if smoke else SELECT_VOCABS
    iters = 3 if smoke else 10
    dt = torch.bfloat16
    print(f"\n== kernel-layer microbench: fused select (T={T} decode rows, "
          f"d={d}, {dev}, bf16, the table's knobs) ==")
    n_sms = (torch.cuda.get_device_properties(dev).multi_processor_count
             if dev.type == "cuda" else 132)
    rows = {}
    for V in vocabs:
        g = torch.Generator(device=dev).manual_seed(V % 1000)
        h = torch.randn((T, d), generator=g, device=dev).to(dt)
        w = (torch.randn((V, d), generator=g, device=dev) * 0.02).to(dt)
        m = torch.rand((T,), generator=g, device=dev) < 0.7

        def dense():
            # the decode iteration's dense selection: (T, V) logits, an
            # fp32 softmax, argmax and gather
            p = torch.softmax((h @ w.t()).float(), -1)
            c = p.argmax(-1)
            return c, p.gather(-1, c[:, None])[:, 0]

        knobs, tuned = _knobs("select", dev, T=T, V=V, n_sms=n_sms,
                              dtype=dt)
        item = h.element_size()
        r = _row(records, "select", dict(T=T, d=d, V=V), dev, knobs, tuned,
                 lambda: fused_select(h, w, m),
                 lambda: sref.select_streaming(h, w, m), dense,
                 bound_ms((T * d + V * d) * item + 4 * T + 8 * T,
                          2 * T * V * d, "bfloat16"), iters)
        if "kernel" in r and "library" in r:
            r["speedup_vs_dense"] = r["library"] / r["kernel"]
            records.append(common.record("select", dict(T=T, d=d, V=V),
                                         "speedup_vs_dense",
                                         r["speedup_vs_dense"], device=dev,
                                         config=r["config"]))
        rows[f"select/V{V}"] = r
    return rows


def run(csv_rows=None, *, device="cuda", smoke=False, results=None):
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        print(f"device: {torch.cuda.get_device_name(dev)}")
    else:
        print(f"kernels on {dev}: shapes, bounds and resolved knobs only; "
              "kernel times are not measured off the card")
    records = [] if results is None else results.setdefault("records", [])
    rows = {}
    with torch.no_grad():
        rows.update(run_attention(records, dev, smoke))
        rows.update(run_select(records, dev, smoke))
    if results is not None:
        results["rows"] = rows
    if csv_rows is not None:
        for name, r in rows.items():
            if "kernel" in r:
                csv_rows.append((f"kernels/{name}", r["kernel"] * 1e3,
                                 f"graph_ms={r['kernel_graph']:.4f};"
                                 f"plain_ms={r.get('plain', 0):.4f};"
                                 f"library_ms={r.get('library', 0):.4f};"
                                 f"library_graph_ms="
                                 f"{r['library_graph']:.4f};"
                                 f"bound_ms={r['bound_ms']:.4f};"
                                 f"table={r['table']}"))
    return csv_rows


def main(argv=None):
    ap = common.make_parser(
        description=__doc__.split("\n")[0],
        smoke_help="small shapes and few iterations (one head layout, one "
                   "vocabulary)")
    ap.add_argument("--tune", action="store_true",
                    help="run tuning.run_sweep on the card first and write "
                         "the cuda table, then bench with it")
    ap.add_argument("--tune-ops", default=None, metavar="OP[,OP...]",
                    help=f"restrict --tune to these ops (of {tuning.OPS})")
    ap.add_argument("--confirm", default=None, metavar="PRIOR.json",
                    help="with --tune: an earlier --tune run's --json; a "
                         "candidate is written only if it won in both")
    args = ap.parse_args(argv)
    if args.tune and args.smoke:
        ap.error("--tune writes the checked-in table and takes full sweeps "
                 "only; drop --smoke")
    if args.confirm and not args.tune:
        ap.error("--confirm goes with --tune")
    results = {"smoke": args.smoke, "records": []}
    if args.tune:
        ops = tuple(args.tune_ops.split(",")) if args.tune_ops else None
        prior = None
        if args.confirm:
            with open(args.confirm) as f:
                prior = json.load(f)["sweep"]
        sweep = []
        results["tuned_entries"] = tuning.run_sweep(
            ops, device=args.device, log=sweep, prior=prior)
        results["sweep"] = sweep
    run(device=args.device, smoke=args.smoke, results=results)
    common.write_results(args.json, results)
    return 0


if __name__ == "__main__":
    sys.exit(main())
