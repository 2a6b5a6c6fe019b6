"""Serving benchmarks of the port, the counterpart of
``benchmarks/bench_serving.py``: static batching against continuous
block-level batching on a Poisson trace with mixed generation caps, the
dense against the paged KV layout at a fixed page budget, and the cost of
preemption in a tight page pool. Two parts:

(a) full width, the card's numbers: qwen2-0.5b (24 layers, d 896, V
    151,936, bf16, seeded random init from ``bridge.init_params``), the
    prompts of ``chip_smoke.py`` phase 3 (P=512), block 32, G up to 256,
    tau 0.9, fused select.
    - schedulers: 48 requests of ``poisson_trace``'s shape (half capped at
      one block, the rest at G) at 1000/s, which saturates the engines;
      then again at half the request rate the continuous engine sustained
      in the first run. Each run through the static ``Engine`` through its
      CUDA graphs and again eagerly (``graphs=False``, the row labelled
      "eager"), and the ``ContinuousEngine`` (CUDA graphs), 8 lanes each.
    - layouts: 96 pages of 32 rows: the dense engine gets 4 lanes (a canvas
      is 24 pages), the paged engine 8 lanes sharing the pool.
    - preemption: ``chip_smoke.py`` phase 3b's tight 40-page pool against a
      dense-equivalent pool (192 pages), its 8 requests at arrival 0 on 8
      lanes, run in turns (equivalent, tight, tight, equivalent).
    Every engine is warmed (its kernel build, its graph captures and one
    untimed batch) before it is timed.
(b) toy, as the JAX bench runs it: the toy student of ``common_torch``, 96
    requests, 4 lanes, then the layouts at a budget of 12 pages. It runs
    with ``--device cpu`` too.

Each run reports tokens/s, makespan, p50/p95 latency (arrival to the last
block), p50/p95 time to first block (arrival to the request's first
``BlockEvent``, read from the engine's ``stream``), peak and average lanes
(``concurrency_stats``), pool peak, stalls and preemptions
(``page_pool_stats``), and, for preemption, the blocks decoded again per
preemption and the tight pool's extra wall time per preemption. These are
columns of the bench; the engines are as they are.

    python3 benchmarks/bench_serving_torch.py --json chiprun_out/s.json
    python3 benchmarks/bench_serving_torch.py --device cpu --smoke   # (b)

Imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from benchmarks import common_torch as common  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import resolve_device  # noqa: E402
from repro_torch.bridge import init_params  # noqa: E402
from repro_torch.configs import ServeConfig, get_config  # noqa: E402
from repro_torch.serving import ContinuousEngine, Engine, Request  # noqa: E402

FULL = dict(config="qwen2-0.5b", prompt_len=512, block=32, gen=256,
            tau=0.9, max_batch=8, requests=48, budget_pages=96)
# chip_smoke.py phase 3's first 8 caps: phase 3b's tight-pool requests
PREEMPT_CAPS = (256, 64, 128, 32, 96, 256, 32, 160)
PREEMPT_POOL = 40


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _pct(xs, q):
    """The JAX bench's percentile: the sorted value at int(q (n - 1))."""
    xs = np.sort(np.asarray(xs, np.float64))
    return float(xs[int(q * (len(xs) - 1))])


def _stream(eng, reqs, t0, outs, first):
    """Every block event of ``reqs`` through ``eng.stream``: each request's
    output into ``outs`` and its first block's time (s from ``t0``) into
    ``first``; returns the number of events."""
    n_events = 0
    for ev in eng.stream(reqs):
        first.setdefault(ev.request_id, time.perf_counter() - t0)
        n_events += 1
        if ev.finished:
            outs[ev.request_id] = ev.output
    return n_events


def _drain(eng, reqs, dev):
    """``reqs`` at once through the engine: (outputs by id, seconds from
    the stream's start to each request's first block, block events, wall
    s)."""
    outs, first = {}, {}
    t0 = time.perf_counter()
    n_events = _stream(eng, reqs, t0, outs, first)
    _sync(dev)
    return outs, first, n_events, time.perf_counter() - t0


def _run_static_trace(eng, reqs, dev):
    """The JAX bench's static replay: chunks of ``max_batch`` in arrival
    order, each launched once its last member has arrived. Latency and
    time to first block: from arrival to the chunk's end (a static batch
    emits every block at once)."""
    B = eng.serve.max_batch
    outs, first, n_events = {}, {}, 0
    t0 = time.perf_counter()
    for i in range(0, len(reqs), B):
        chunk = reqs[i:i + B]
        wait = max(r.arrival_s for r in chunk) - (time.perf_counter() - t0)
        if wait > 0:
            time.sleep(wait)
        n_events += _stream(eng, chunk, t0, outs, first)
        _sync(dev)
    return outs, first, n_events, time.perf_counter() - t0


def _stats(name, reqs, outs, first, wall, eng=None, static=False):
    """One run's columns."""
    arrival = {r.id: r.arrival_s for r in reqs}
    if sorted(outs) != sorted(arrival):
        raise AssertionError(f"{name}: {len(outs)} of {len(reqs)} requests "
                             "completed")
    tokens = sum(o.gen_length for o in outs.values())
    # static: arrival to the chunk's end; continuous: the engine's own
    # arrival-to-last-block latency
    lat = [first[i] - arrival[i] if static else outs[i].latency_s
           for i in arrival]
    ttfb = [first[i] - arrival[i] for i in arrival]
    row = {"tokens": tokens, "makespan_s": wall,
           "tps": tokens / wall if wall > 0 else float("inf"),
           "latency_p50_s": _pct(lat, 0.5), "latency_p95_s": _pct(lat, 0.95),
           "ttfb_p50_s": _pct(ttfb, 0.5), "ttfb_p95_s": _pct(ttfb, 0.95),
           "mean_steps": float(np.mean([o.steps for o in outs.values()]))}
    if isinstance(eng, ContinuousEngine):
        row.update(eng.concurrency_stats())
        row["pool"] = eng.page_pool_stats()
        row["calls"] = eng.call_counts()
    return row


HEADER = (f"{'run':22s} {'tok/s':>9} {'makespan':>9} {'p50 lat':>8} "
          f"{'p95 lat':>8} {'p50 TTFB':>8} {'p95 TTFB':>8} {'peak':>5} "
          f"{'avg':>5} {'tokens':>7}")


def _print(name, r):
    print(f"{name:22s} {r['tps']:>9.1f} {r['makespan_s']:>8.3f}s "
          f"{r['latency_p50_s']:>7.3f}s {r['latency_p95_s']:>7.3f}s "
          f"{r['ttfb_p50_s']:>7.3f}s {r['ttfb_p95_s']:>7.3f}s "
          f"{r.get('peak_lanes', float('nan')):>5.1f} "
          f"{r.get('avg_lanes', float('nan')):>5.2f} {r['tokens']:>7d}",
          flush=True)


def _record(records, op, shape, row, dev, config):
    for metric in ("tps", "makespan_s", "latency_p50_s", "latency_p95_s",
                   "ttfb_p50_s", "ttfb_p95_s", "peak_lanes", "avg_lanes"):
        if metric in row:
            records.append(common.record(op, shape, metric, row[metric],
                                         device=dev, config=config))


def _warm(eng, reqs, dev):
    """Build, capture and run one untimed batch: the first ``max_batch``
    requests, capped at one block, arriving at once."""
    eng.warmup()
    B = eng.serve.block_size
    eng.generate([dataclasses.replace(r, id=None, max_tokens=B,
                                      arrival_s=0.0, params=None)
                  for r in reqs[:eng.serve.max_batch]])
    _sync(dev)


def _zero_arrivals(reqs):
    for r in reqs:
        r.arrival_s = 0.0
    return reqs


def run_schedulers(params, cfg, *, dev, prompt_len, block, gen, tau,
                   max_batch, n_requests, rate_hz, records, prompts=None,
                   fused_select=False, runs=1, label="schedulers",
                   eager_static=True):
    """Static against continuous on ``poisson_trace`` at ``rate_hz`` (None:
    every arrival at 0); ``runs`` 2 repeats the pair at half the request
    rate the continuous engine sustained in the first run. On CUDA the
    static engine runs through its graphs and, with ``eager_static``,
    again eagerly (``static_eager``). Returns the runs' rows (with each
    engine's outputs under ``outputs``)."""
    kw = dict(block_size=block, gen_length=gen, sampler="cdlm",
              conf_threshold=tau, max_batch=max_batch,
              fused_select=fused_select)
    statics = {"static": Engine(params, cfg,
                                ServeConfig(scheduler="static", **kw),
                                prompt_len=prompt_len, device=dev)}
    if eager_static and statics["static"].graphed:
        statics["static_eager"] = Engine(
            params, cfg, ServeConfig(scheduler="static", **kw),
            prompt_len=prompt_len, device=dev, graphs=False)
    cont = ContinuousEngine(params, cfg,
                            ServeConfig(scheduler="continuous", **kw),
                            prompt_len=prompt_len, device=dev)
    out, rate = [], rate_hz
    for i in range(runs):
        reqs = common.poisson_trace(n=n_requests, rate_hz=rate or 1.0,
                                    seed=0, prompts=prompts, block=block,
                                    gen_len=gen)
        if rate is None:
            _zero_arrivals(reqs)
        if i == 0:
            for eng in list(statics.values()) + [cont]:
                _warm(eng, reqs, dev)
        shape = dict(n_requests=n_requests, max_batch=max_batch,
                     rate_hz=rate, prompt_len=prompt_len, gen=gen,
                     block=block)
        print(f"\n== serving schedulers, {label} ({n_requests} reqs, "
              f"Poisson {rate if rate is None else round(rate, 3)}/s, "
              f"batch {max_batch}, mixed max_tokens, {dev}) ==")
        print(HEADER)
        row = {"rate_hz": rate, "outputs": {}}
        for name, eng in statics.items():
            so, sf, _, sw = _run_static_trace(eng, reqs, dev)
            row[name] = _stats(name, reqs, so, sf, sw, eng, static=True)
            row["outputs"][name] = so
            _print(f"static ({'graphs' if eng.graphed else 'eager'})",
                   row[name])
            _record(records, f"serving_sched/{label}", shape, row[name],
                    dev, {"scheduler": "static", "graphs": eng.graphed})
        co, cf, _, cw = _drain(cont, reqs, dev)
        graphs = "graphs" if cont.graphed else "eager"
        c = _stats("continuous", reqs, co, cf, cw, cont)
        _print(f"continuous ({graphs})", c)
        s = row["static"]
        ratio = c["tps"] / s["tps"] if s["tps"] else float("inf")
        print(f"continuous/static throughput: x{ratio:.2f}")
        _record(records, f"serving_sched/{label}", shape, c, dev,
                {"scheduler": "continuous", "graphs": cont.graphed})
        records.append(common.record(f"serving_sched/{label}", shape,
                                     "continuous_static_speedup", ratio,
                                     device=dev))
        if "static_eager" in row:
            e = row["static_eager"]
            row["static_graph_speedup"] = (s["tps"] / e["tps"] if e["tps"]
                                           else float("inf"))
            print(f"static graphs/eager throughput: "
                  f"x{row['static_graph_speedup']:.2f}")
            records.append(common.record(
                f"serving_sched/{label}", shape, "static_graph_speedup",
                row["static_graph_speedup"], device=dev))
        row.update(continuous=c, speedup=ratio)
        row["outputs"]["continuous"] = co
        out.append(row)
        # the second run: half the request rate the continuous engine
        # sustained in this one
        rate = 0.5 * n_requests / cw
    return out


def run_layouts(params, cfg, *, dev, prompt_len, block, gen, tau,
                n_requests, rate_hz, budget_pages, records, prompts=None,
                fused_select=False, label="layouts"):
    """Dense against paged at one page budget: the dense engine gets the
    lanes whose whole canvases the budget holds, the paged engine twice as
    many sharing the budget as a pool. ``rate_hz`` None: every arrival at
    0. Returns {layout: row} (with its outputs)."""
    n_tables = -(-(prompt_len + gen) // block)
    dense_lanes = max(1, budget_pages // n_tables)
    paged_lanes = 2 * dense_lanes
    page_mb = common.kv_page_bytes(cfg, block, cfg.dtype) / 1e6
    reqs = common.poisson_trace(n=n_requests, rate_hz=rate_hz or 1.0, seed=1,
                                prompts=prompts, block=block, gen_len=gen)
    if rate_hz is None:
        _zero_arrivals(reqs)
    kw = dict(block_size=block, gen_length=gen, sampler="cdlm",
              conf_threshold=tau, scheduler="continuous",
              fused_select=fused_select)
    engines = {
        "dense": ContinuousEngine(params, cfg,
                                  ServeConfig(max_batch=dense_lanes, **kw),
                                  prompt_len=prompt_len, device=dev),
        "paged": ContinuousEngine(params, cfg, ServeConfig(
            max_batch=paged_lanes, cache_layout="paged",
            page_pool_pages=budget_pages, **kw), prompt_len=prompt_len,
            device=dev)}
    for eng in engines.values():
        _warm(eng, reqs, dev)
    print(f"\n== cache layouts at a fixed budget, {label} ({budget_pages} "
          f"pages = {budget_pages * page_mb:.2f} MB KV; {n_requests} reqs, "
          f"mixed max_tokens; dense {dense_lanes} lanes, paged {paged_lanes} "
          f"lanes, {dev}) ==")
    print(HEADER + f" {'pool peak':>9} {'stalls':>6} {'preempt':>7}")
    rows = {}
    shape = dict(n_requests=n_requests, budget_pages=budget_pages,
                 dense_lanes=dense_lanes, paged_lanes=paged_lanes,
                 rate_hz=rate_hz, prompt_len=prompt_len, gen=gen,
                 block=block)
    for name, eng in engines.items():
        outs, first, _, wall = _drain(eng, reqs, dev)
        r = _stats(name, reqs, outs, first, wall, eng)
        _print(name, r)
        if name == "paged":
            p = r["pool"]
            print(f"{'':22s} pool peak {p['peak_occupancy']:.0%}, stalls "
                  f"{p['stall_rounds']:.0f}, preemptions "
                  f"{p['preemptions']:.0f}")
        _record(records, f"serving_layout/{label}", shape, r, dev,
                {"layout": name})
        rows[name] = dict(r, outputs=outs)
    gain = rows["paged"]["peak_lanes"] / max(rows["dense"]["peak_lanes"], 1)
    print(f"paged/dense peak concurrency at fixed memory: x{gain:.2f}")
    pool = rows["paged"]["pool"]
    for metric, value in (("concurrency_gain", gain),
                          ("stall_rounds", pool["stall_rounds"]),
                          ("preemptions", pool["preemptions"])):
        records.append(common.record(f"serving_layout/{label}", shape, metric,
                                     value, device=dev))
    rows["concurrency_gain"] = gain
    rows["page_mb"] = page_mb
    return rows


def run_preemption(params, cfg, *, dev, prompts, block, gen, tau, records,
                   fused_select=True):
    """Phase 3b's tight pool (PREEMPT_POOL pages) against a
    dense-equivalent pool on its 8 requests at arrival 0, 8 lanes, in
    turns (equivalent, tight, tight, equivalent); tokens must be equal.
    Preemption cost: the blocks decoded again per preemption (blocks
    decoded, from the lanes a decode step ran times the steps, less the
    blocks streamed), and the extra wall per preemption (mean tight wall
    less mean equivalent wall, over the preemptions)."""
    P = prompts.shape[1]
    reqs = [Request(prompt=prompts[i], id=i, max_tokens=c)
            for i, c in enumerate(PREEMPT_CAPS)]
    kw = dict(block_size=block, gen_length=gen, sampler="cdlm",
              conf_threshold=tau, scheduler="continuous",
              cache_layout="paged", fused_select=fused_select,
              max_batch=len(reqs))
    engines = {"equivalent": ContinuousEngine(
                   params, cfg, ServeConfig(**kw), prompt_len=P, device=dev),
               "tight": ContinuousEngine(
                   params, cfg, ServeConfig(page_pool_pages=PREEMPT_POOL,
                                            **kw), prompt_len=P, device=dev)}
    for eng in engines.values():
        _warm(eng, reqs, dev)
    got = {"equivalent": [], "tight": []}
    for name in ("equivalent", "tight", "tight", "equivalent"):
        eng = engines[name]
        outs, first, n_events, wall = _drain(eng, reqs, dev)
        r = _stats(name, reqs, outs, first, wall, eng)
        decoded = round(r["avg_lanes"] * r["calls"]["commit"])
        r.update(blocks_decoded=decoded, blocks_streamed=n_events,
                 outputs=outs)
        got[name].append(r)
    eq, tight = got["equivalent"][0], got["tight"][0]
    for rid, o in tight["outputs"].items():
        if not np.array_equal(o.tokens, eq["outputs"][rid].tokens):
            raise AssertionError(f"preemption: request {rid}'s tokens differ "
                                 "between the tight and the equivalent pool")
    pre = tight["pool"]["preemptions"]
    redo = tight["blocks_decoded"] - tight["blocks_streamed"]
    wall = {k: float(np.mean([r["makespan_s"] for r in v]))
            for k, v in got.items()}
    res = {"pool_pages": {k: engines[k].n_pages for k in engines},
           "preemptions": pre, "stall_rounds": tight["pool"]["stall_rounds"],
           "pool_peak_pages": tight["pool"]["peak_pages"],
           "blocks_decoded": tight["blocks_decoded"],
           "blocks_streamed": tight["blocks_streamed"],
           "blocks_redecoded_per_preemption": redo / pre if pre else None,
           "wall_s": wall,
           "walls_s": {k: [r["makespan_s"] for r in v]
                       for k, v in got.items()},
           "extra_wall_per_preemption_s":
               (wall["tight"] - wall["equivalent"]) / pre if pre else None,
           "ttfb_p50_s": {k: v[0]["ttfb_p50_s"] for k, v in got.items()},
           "ttfb_p95_s": {k: v[0]["ttfb_p95_s"] for k, v in got.items()},
           "tps": {k: float(np.mean([r["tps"] for r in v]))
                   for k, v in got.items()}}
    print(f"\n== preemption: a {PREEMPT_POOL}-page pool against "
          f"{engines['equivalent'].n_pages} pages, {len(reqs)} requests at "
          f"once, {len(reqs)} lanes, {dev} ==")
    print(f"preemptions {pre:.0f}, stall rounds "
          f"{res['stall_rounds']:.0f}, blocks decoded "
          f"{tight['blocks_decoded']} of which streamed "
          f"{tight['blocks_streamed']}: "
          f"{res['blocks_redecoded_per_preemption']} blocks again per "
          f"preemption; walls {res['walls_s']}; extra wall per preemption "
          f"{res['extra_wall_per_preemption_s']} s; tokens equal")
    shape = dict(n_requests=len(reqs), lanes=len(reqs),
                 pool_pages=PREEMPT_POOL, prompt_len=P, gen=gen, block=block)
    for metric in ("preemptions", "stall_rounds",
                   "blocks_redecoded_per_preemption",
                   "extra_wall_per_preemption_s"):
        if res[metric] is not None:
            records.append(common.record("serving_preemption", shape, metric,
                                         res[metric], device=dev))
    return res


def full_params(dev):
    """qwen2-0.5b at full width, bf16, seeded random init, the mask token's
    row zero (as in a trained model, it is never a candidate): the params
    of ``chip_smoke.py`` phase 3."""
    cfg = get_config(FULL["config"])
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev, "bfloat16")
    params["embed"]["tok"][cfg.mask_token_id] = 0
    return cfg, params


def run_full(dev, records, *, n_requests=FULL["requests"], layouts=True,
             preemption=True, eager_static=True):
    """Part (a). ``n_requests`` cuts the trace (the layouts take two
    thirds of it, at least 8); widths are never cut. ``eager_static``
    False leaves out the static engine's eager rows."""
    if dev.type != "cuda":
        raise RuntimeError("part (a) serves qwen2-0.5b at full width: it "
                           "runs on the card (part (b) runs anywhere)")
    cfg, params = full_params(dev)
    P, B, G = FULL["prompt_len"], FULL["block"], FULL["gen"]
    rng = np.random.default_rng(0)
    n_prompts = max(n_requests, len(PREEMPT_CAPS))
    prompts = rng.integers(0, cfg.mask_token_id, (n_prompts, P))
    common_kw = dict(dev=dev, block=B, gen=G, tau=FULL["tau"],
                     records=records, fused_select=True)
    res = {"schedulers": run_schedulers(
        params, cfg, prompt_len=P, max_batch=FULL["max_batch"],
        n_requests=n_requests, rate_hz=1000.0, prompts=prompts, runs=2,
        label="full", eager_static=eager_static, **common_kw)}
    if layouts:
        res["layouts"] = run_layouts(
            params, cfg, prompt_len=P, n_requests=max(8, n_requests * 2 // 3),
            rate_hz=1000.0, budget_pages=FULL["budget_pages"],
            prompts=prompts, label="full", **common_kw)
    if preemption:
        res["preemption"] = run_preemption(params, cfg, prompts=prompts,
                                           **common_kw)
    return res


def run_toy(dev, records, *, params=None, smoke=False, n_requests=96,
            max_batch=4, rate_hz=1000.0, budget_pages=12):
    """Part (b): the JAX bench's ``run`` on the toy student."""
    if params is None:
        params = common.get_student(device=dev, smoke=smoke)
    kw = dict(dev=dev, prompt_len=common.TASK.prompt_len,
              block=common.CDLM_CFG.block_size, gen=common.TASK.gen_len,
              tau=0.9, records=records)
    res = {"schedulers": run_schedulers(
        params, common.CFG, max_batch=max_batch, n_requests=n_requests,
        rate_hz=rate_hz, label="toy", **kw)}
    res["layouts"] = run_layouts(
        params, common.CFG, n_requests=max(8, n_requests * 2 // 3),
        rate_hz=rate_hz, budget_pages=budget_pages, label="toy", **kw)
    return res


def _summary(res):
    """``res`` without the per-request outputs (for the JSON file)."""
    if isinstance(res, dict):
        return {k: _summary(v) for k, v in res.items() if k != "outputs"}
    if isinstance(res, list):
        return [_summary(v) for v in res]
    return res


def run(csv_rows=None, *, device="cuda", smoke=False, results=None,
        part=None, requests=None):
    """Part (a) on the card, then part (b); part (b) only off the card.
    ``smoke``: 16 requests in each part."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        print(f"device: {torch.cuda.get_device_name(dev)}")
    part = part or ("both" if dev.type == "cuda" else "b")
    n = requests or (16 if smoke else None)
    records = [] if results is None else results.setdefault("records", [])
    out = {}
    if part in ("a", "both"):
        out["full"] = run_full(dev, records,
                               n_requests=n or FULL["requests"])
    if part in ("b", "both"):
        out["toy"] = run_toy(dev, records, smoke=smoke, n_requests=n or 96)
    if results is not None:
        results.update(_summary(out))
    if csv_rows is not None:
        for key, res in out.items():
            for r in res["schedulers"]:
                for sched in ("static", "static_eager", "continuous"):
                    if sched not in r:
                        continue
                    row = r[sched]
                    csv_rows.append((
                        f"serving_{key}/{sched}_rate{r['rate_hz']:.1f}",
                        row["makespan_s"] * 1e6 / len(r["outputs"][sched]),
                        f"tps={row['tps']:.1f};p50_ttfb_s="
                        f"{row['ttfb_p50_s']:.4f};p95_lat_s="
                        f"{row['latency_p95_s']:.4f}"))
            lay = res["layouts"]
            csv_rows.append((f"serving_{key}/paged_concurrency_gain", 0.0,
                             f"{lay['concurrency_gain']:.2f}"))
            if "preemption" in res:
                p = res["preemption"]
                csv_rows.append((
                    f"serving_{key}/preemption", 0.0,
                    f"preemptions={p['preemptions']:.0f};redecoded_per="
                    f"{p['blocks_redecoded_per_preemption']};extra_s_per="
                    f"{p['extra_wall_per_preemption_s']}"))
    return csv_rows


def main(argv=None):
    ap = common.make_parser(
        description=__doc__.split("\n")[0],
        smoke_help="16 requests in each part")
    ap.add_argument("--part", choices=["a", "b", "both"], default=None,
                    help="(a) full width on the card, (b) the toy; default "
                         "both on the card, (b) elsewhere")
    ap.add_argument("--requests", type=int, default=None,
                    help="requests of each part's scheduler trace")
    args = ap.parse_args(argv)
    results = {"smoke": args.smoke, "records": []}
    run(device=args.device, smoke=args.smoke, results=results,
        part=args.part, requests=args.requests)
    common.write_results(args.json, results)
    return 0


if __name__ == "__main__":
    sys.exit(main())
