"""Tables 1-2 on the card: TPS, latency, steps, calls and generation
length of the paper's six decoders (the naive DLM, Fast-dLLM parallel,
Fast-dLLM with the dual cache, the interval cache, CDLM and AR), each
beside its ratio to ``vanilla``, in two parts:

(a) full width: qwen2-0.5b (24 layers, d 896, 14/2 heads, V 151,936,
    bf16, seeded random init), all six decoders through the static
    ``Engine`` on the same 8 prompts, P=512, G=64, block 32, tau 0.9,
    greedy, fused select, the second of two timed runs after a warm-up
    batch. A random-init model finalizes one token an
    iteration, so every threshold decoder runs G iterations: this part
    measures what each decoder's cache policy costs an iteration (the
    paper's KV-caching argument), not its step reduction. Each decoder
    runs twice in the call: through the static engine's CUDA graphs (its
    default) and eagerly (``graphs=False``), each row beside its ratio to
    ``vanilla`` on the same path.
(b) toy, as ``benchmarks/bench_main_results.py`` runs it: the port's toy
    teacher, CDLM student and AR model (``common_torch``: trained on the
    device and cached under ``experiments/bench_assets_torch/``), 64
    prompts of the sort task, with the task ``score`` too. This part
    measures step reduction and quality.

    python3 benchmarks/bench_main_results_torch.py            # the card
    python3 benchmarks/bench_main_results_torch.py --device cpu --toy

Off the card part (a) is left out.

Imports nothing of JAX.
"""
from __future__ import annotations

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
from repro_torch.core.sampler import SAMPLERS  # noqa: E402
from repro_torch.serving import Engine, Request  # noqa: E402

FULL = dict(lanes=8, prompt_len=512, gen=64, block=32, tau=0.9)
TOY_METHODS = [
    ("vanilla-DLM (teacher)", "vanilla", "teacher", {}),
    ("dLLM-Cache (interval)", "interval_cache", "teacher", {}),
    ("Fast-dLLM (Par.)", "fast_dllm", "teacher", {}),
    ("Fast-dLLM (Par.+D.C.)", "dual_cache", "teacher", {}),
    ("CDLM (ours)", "cdlm", "student", {"early_stop": True}),
    ("AR baseline", "ar", "ar", {"early_stop": True}),
]


def _ratios(r, base):
    return (r["tps"] / base["tps"] if base["tps"] else 0.0,
            base["latency_s"] / r["latency_s"] if r["latency_s"] else 0.0)


def _row(name, r, base, score=True):
    x_tps, x_lat = _ratios(r, base)
    sc = f" {r['score']:>6.2f}" if score else ""
    return (f"{name:24s} {r['tps']:>9.1f} {r['latency_s'] * 1e3:>9.2f} "
            f"{r['steps']:>7.1f} {r['calls']:>6d} {r['gen_len']:>7.1f}{sc}"
            f"   (x{x_tps:.2f} TPS, x{x_lat:.2f} lat)")


def _header(score=True):
    return (f"{'method':24s} {'TPS':>9} {'lat(ms)':>9} {'steps':>7} "
            f"{'calls':>6} {'genlen':>7}" + (f" {'score':>6}" if score
                                               else ""))


def full_width(dev, records):
    """(a): every decoder through the static engine on one batch of 8
    prompts, through its graphs and eagerly; returns its rows, named
    ``<decoder>/graphs`` and ``<decoder>/eager``."""
    cfg = get_config("qwen2-0.5b")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev, "bfloat16")
    # as in a trained model, the mask token is never a candidate
    params["embed"]["tok"][cfg.mask_token_id] = 0
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.mask_token_id,
                           (FULL["lanes"], FULL["prompt_len"]))
    rows, base = [], {}
    print(f"\n== Tables 1-2, full width (qwen2-0.5b, bf16, random init, "
          f"{FULL['lanes']} prompts, P={FULL['prompt_len']}, "
          f"G={FULL['gen']}, block {FULL['block']}, {dev}) ==")
    print(_header(score=False))
    for name, path in ((n, p) for n in SAMPLERS for p in ("graphs",
                                                          "eager")):
        serve = ServeConfig(max_batch=FULL["lanes"], block_size=FULL["block"],
                            gen_length=FULL["gen"], conf_threshold=FULL["tau"],
                            sampler=name, fused_select=True)
        eng = Engine(params, cfg, serve, prompt_len=FULL["prompt_len"],
                     device=dev, graphs=None if path == "graphs" else False)
        eng.warmup()
        reqs = [Request(prompt=p, id=i) for i, p in enumerate(prompts)]
        walls = []
        for _ in range(2):      # the second run is the row
            t0 = time.perf_counter()
            outs = eng.generate(reqs)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            walls.append(time.perf_counter() - t0)
        wall = walls[-1]
        glen = float(np.mean([o.gen_length for o in outs]))
        r = {"tps": sum(o.gen_length for o in outs) / wall,
             "latency_s": float(np.mean([o.latency_s for o in outs])),
             "steps": float(np.mean([o.steps for o in outs])),
             "calls": eng.call_counts()["total"], "gen_len": glen,
             "wall_s": wall}
        r["ms_per_call"] = wall * 1e3 / r["calls"]
        base.setdefault(path, r)
        rows.append((f"{name}/{path}", r))
        print(_row(f"{name} ({path})", r, base[path], score=False)
              + f"  {r['ms_per_call']:.2f} ms a call; walls "
              f"{walls[0]:.3f}, {walls[1]:.3f} s")
        x_tps, x_lat = _ratios(r, base[path])
        shape = dict(FULL, config="qwen2-0.5b", dtype="bfloat16",
                     graphs=path == "graphs")
        for metric in ("tps", "latency_s", "steps", "calls", "gen_len",
                       "wall_s", "ms_per_call"):
            records.append(common.record(f"main_results_full/{name}", shape,
                                         metric, r[metric], device=dev))
        records.append(common.record(f"main_results_full/{name}", shape,
                                     "first_wall_s", walls[0], device=dev))
        records.append(common.record(f"main_results_full/{name}", shape,
                                     "x_tps", x_tps, device=dev))
        records.append(common.record(f"main_results_full/{name}", shape,
                                     "x_latency", x_lat, device=dev))
    return rows


def toy(dev, records, smoke=False):
    """(b): the toy assets on the device, 64 eval prompts per decoder."""
    assets = {"teacher": common.get_teacher(dev, smoke)}
    assets["student"] = common.get_student(assets["teacher"], device=dev,
                                           smoke=smoke)
    assets["ar"] = common.get_ar(dev, smoke)
    print(f"\n== Tables 1-2, toy (sort task, {common.CFG.n_layers}L "
          f"d{common.CFG.d_model}, {dev}"
          f"{', smoke budgets' if smoke else ''}) ==")
    print(_header())
    rows, base = [], None
    for label, key, asset, kw in TOY_METHODS:
        r = common.eval_sampler(assets[asset], SAMPLERS[key], **kw)
        base = base or r
        rows.append((key, r))
        print(_row(label, r, base))
        x_tps, x_lat = _ratios(r, base)
        shape = {"n": 64, "task": common.TASK.name,
                 "n_layers": common.CFG.n_layers,
                 "d_model": common.CFG.d_model, "smoke": smoke}
        for metric in ("tps", "latency_s", "steps", "calls", "gen_len",
                       "score"):
            records.append(common.record(f"main_results_toy/{key}", shape,
                                         metric, r[metric], device=dev))
        records.append(common.record(f"main_results_toy/{key}", shape,
                                     "x_tps", x_tps, device=dev))
        records.append(common.record(f"main_results_toy/{key}", shape,
                                     "x_latency", x_lat, device=dev))
    return rows


def run(csv_rows=None, *, device="cuda", smoke=False, toy_only=False,
        records=None):
    """(a) on the card (not with ``toy_only``; off the card it is left
    out, with a note), then (b); the CSV rows of ``benchmarks/run_torch.py
    all``."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        print(f"device: {torch.cuda.get_device_name(dev)}")
    records = [] if records is None else records
    rows = []
    if not toy_only:
        if dev.type == "cuda":
            rows += [(f"full/{k}", r) for k, r in full_width(dev, records)]
        else:
            print("part (a) serves qwen2-0.5b at full width on the card; "
                  f"left out on {dev}")
    rows += [(f"toy/{k}", r) for k, r in toy(dev, records, smoke=smoke)]
    if csv_rows is not None:
        for name, r in rows:
            score = f";score={r['score']:.2f}" if "score" in r else ""
            csv_rows.append((f"main_results/{name}", r["latency_s"] * 1e6,
                             f"tps={r['tps']:.1f};steps={r['steps']:.1f};"
                             f"calls={r['calls']}{score}"))
    return csv_rows


def main(argv=None):
    ap = common.make_parser(__doc__.split("\n")[0])
    ap.add_argument("--toy", action="store_true",
                    help="only (b), the toy half")
    args = ap.parse_args(argv)
    records = []
    run(device=args.device, smoke=args.smoke, toy_only=args.toy,
        records=records)
    common.write_results(args.json, records)
    return 0


if __name__ == "__main__":
    sys.exit(main())
