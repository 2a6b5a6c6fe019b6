"""End-to-end serving on the PyTorch port, the counterpart of
``examples/serve_blockwise.py``: serve the toy CDLM student (and the
teacher for the baselines) with batched requests through the serving
engines, reporting the paper's efficiency columns for every sampler
strategy, then the CDLM strategy under the continuous block-level
batching scheduler (``ContinuousEngine``: finished lanes are evicted at
block boundaries and queued requests admitted mid-flight).

``--stream`` demos block-at-a-time streaming (blocks print the moment they
commit; block-causal finalization means a printed block never changes),
and ``--http`` boots the HTTP frontend (``/v1/completions`` with SSE,
``/healthz``, ``/metrics``) over the CDLM student.

    python examples/serve_blockwise_torch.py [--sampler cdlm]
    python examples/serve_blockwise_torch.py --stream
    python examples/serve_blockwise_torch.py --http --port 8000
    python examples/serve_blockwise_torch.py --device cpu --smoke \
        --requests 8 --batch 4        # toy assets of a few steps, on a CPU
    python examples/serve_blockwise_torch.py --steps 60   # trained here

The toy assets are trained on first use and cached under
``experiments/bench_assets_torch/`` (``--smoke``: ``smoke/``), as the
port's benches do (``benchmarks/common_torch.py``); ``--steps N`` trains
the teacher and the student for N steps each in memory instead.
"""
import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from benchmarks import common_torch as common
from repro_torch import resolve_device
from repro_torch.configs import ServeConfig, TrainConfig
from repro_torch.data import verify
from repro_torch.serving import Request, efficiency_report, make_engine
from repro_torch.training import trainer

SAMPLERS = ["vanilla", "fast_dllm", "dual_cache", "interval_cache", "cdlm"]


def train_assets(steps, device):
    """The toy teacher and CDLM student of ``common_torch``, trained for
    ``steps`` each (the student on 64 prompts' trajectories)."""
    print(f"training the toy teacher and student, {steps} steps each...")
    dev = resolve_device(device)
    tcfg = TrainConfig(learning_rate=2e-3, steps=steps, batch_size=64,
                       remat=False)
    teacher = trainer.train_teacher(common.CFG, common.corpus(), tcfg,
                                    verbose=False, device=dev)
    ds = trainer.collect_dataset(teacher, common.CFG, common.CDLM_CFG,
                                 common.corpus(), n_examples=64, batch=64,
                                 verbose=False)
    student = trainer.train_student(
        teacher, ds, common.CFG, common.CDLM_CFG,
        dataclasses.replace(tcfg, learning_rate=5e-4), verbose=False)
    return teacher, student


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sampler", default="all", choices=["all"] + SAMPLERS)
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--stream", action="store_true",
                    help="demo exact block-at-a-time streaming through the "
                         "continuous engine (cdlm student)")
    ap.add_argument("--http", action="store_true",
                    help="serve the cdlm student over HTTP "
                         "(/v1/completions + SSE) instead of the table")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="toy assets trained for a few steps")
    ap.add_argument("--steps", type=int, default=None,
                    help="train the toy teacher and student for this many "
                         "steps each, in memory, instead of the cached "
                         "assets")
    args = ap.parse_args(argv)

    if args.steps is not None:
        teacher, student = train_assets(args.steps, args.device)
    else:
        print("loading/training assets (cached under "
              "experiments/bench_assets_torch)...")
        teacher = common.get_teacher(args.device, smoke=args.smoke)
        student = common.get_student(teacher, device=args.device,
                                     smoke=args.smoke)
    ev = common.corpus().eval_batch(args.requests)
    reqs = [Request(prompt=p, id=i) for i, p in enumerate(ev["prompt"])]

    def engine(params, name, sched):
        serve = ServeConfig(max_batch=args.batch,
                            block_size=common.CDLM_CFG.block_size,
                            gen_length=common.TASK.gen_len, sampler=name,
                            scheduler=sched)
        return make_engine(params, common.CFG, serve,
                           prompt_len=common.TASK.prompt_len,
                           device=args.device)

    if args.http or args.stream:
        eng = engine(student, "cdlm", "continuous")
        eng.warmup(per_request=args.http)
        if args.http:
            from repro_torch.serving.server import serve_http
            print(f"serving /v1/completions on http://127.0.0.1:{args.port} "
                  f"(prompt_len={common.TASK.prompt_len}); Ctrl-C to stop")
            serve_http(eng, "127.0.0.1", args.port)
            return []
        print("streaming blocks as they commit (id:block -> tokens):")
        events = list(eng.stream(reqs[:args.batch + 2]))
        for ev_ in events:
            tag = " <done>" if ev_.finished else ""
            print(f"  {ev_.request_id}:{ev_.index} -> "
                  f"{np.asarray(ev_.tokens).tolist()}{tag}")
        return events

    samplers = SAMPLERS if args.sampler == "all" else [args.sampler]
    rows = [(name, "static") for name in samplers]
    if args.sampler in ("all", "cdlm"):
        rows.append(("cdlm", "continuous"))

    # TPS is total served tokens / wall-clock for the whole request set, so
    # the column is comparable across schedulers
    print(f"\n{'sampler':16s} {'sched':11s} {'TPS':>8} {'lat(ms)':>9} "
          f"{'steps':>7} {'genlen':>7} {'score':>6}")
    table = []
    for name, sched in rows:
        eng = engine(student if name == "cdlm" else teacher, name, sched)
        eng.warmup()
        t0 = time.perf_counter()
        resp = eng.generate(reqs)
        wall = time.perf_counter() - t0
        rep = efficiency_report(resp)
        tps = sum(r.gen_length for r in resp) / wall if wall else 0.0
        ok = float(np.mean([verify(ev["prompt"][r.id], r.tokens,
                                   common.TASK) for r in resp]))
        print(f"{name:16s} {sched:11s} {tps:>8.0f} "
              f"{rep['latency_s']*1e3:>9.2f} {rep['steps']:>7.1f} "
              f"{rep['gen_length']:>7.1f} {ok:>6.2f}")
        table.append({"sampler": name, "scheduler": sched, "tps": tps,
                      "n": len(resp), **rep, "score": ok})
    return table


if __name__ == "__main__":
    main()
