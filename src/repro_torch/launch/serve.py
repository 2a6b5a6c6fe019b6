"""Serving CLI of the port: CDLM decoding through the continuous engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --fused-select
    PYTHONPATH=src python -m repro_torch.launch.serve --config qwen2-0.5b \\
        --reduced --device cpu --prompt-len 16 --gen-length 32 --fused-select
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \\
        --prompt-len 16 --gen-length 32 --block-size 8 --cache-layout paged \\
        --pool-pages 8

Params come from ``--ckpt`` (an npz written by the JAX package's
``checkpoint/io.py``, converted by ``repro_torch.bridge``) or, without it,
from a seeded random init on the device. Prompts are random tokens drawn
from ``--seed``. Prints one ``TPS=... latency=... steps=... gen_len=...``
line, as the JAX package's ``launch/serve.py`` does, and on the paged
layout its ``page pool:`` occupancy line.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default="qwen2-0.5b")
    ap.add_argument("--reduced", action="store_true",
                    help="the config's reduced smoke-test variant")
    ap.add_argument("--ckpt", default=None, help="npz checkpoint")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default=None,
                    help="param dtype (default: the config's)")
    ap.add_argument("--fused-select", action="store_true", default=True,
                    help="always on: the port decodes through the fused "
                         "unembed + select kernel only (the flag is taken "
                         "so the JAX CLI's command line runs unchanged)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--threshold", type=float, default=0.9)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--gen-length", type=int, default=256)
    ap.add_argument("--block-size", type=int, default=32)
    ap.add_argument("--cache-layout", default="dense",
                    choices=["dense", "paged"],
                    help="KV memory layout: dense per-lane buffers, or a "
                         "global page pool + per-lane page tables "
                         "(page size = block size)")
    ap.add_argument("--pool-pages", type=int, default=None,
                    help="paged layout: page-pool size in pages "
                         "(default: dense-equivalent capacity)")
    args = ap.parse_args(argv)

    from repro_torch import resolve_device
    from repro_torch.bridge import init_params, params_from_jax
    from repro_torch.configs import ServeConfig, get_config
    from repro_torch.serving import (
        ContinuousEngine,
        Request,
        efficiency_report,
    )

    cfg = get_config(args.config)
    if args.reduced:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    if args.ckpt:
        with np.load(args.ckpt) as data:
            params = params_from_jax(data, cfg, dev, args.dtype)
    else:
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        params = init_params(cfg, gen, dev, args.dtype)
    serve = ServeConfig(max_batch=args.batch, block_size=args.block_size,
                        gen_length=args.gen_length,
                        conf_threshold=args.threshold,
                        scheduler="continuous",
                        cache_layout=args.cache_layout,
                        page_pool_pages=args.pool_pages,
                        fused_select=True)
    eng = ContinuousEngine(params, cfg, serve, prompt_len=args.prompt_len,
                           device=dev)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(2, cfg.vocab_size,
                           (args.requests, args.prompt_len))
    prompts[prompts == cfg.mask_token_id] = 2
    reqs = [Request(prompt=p, id=i) for i, p in enumerate(prompts)]
    eng.warmup()
    t0 = time.perf_counter()
    resp = eng.generate(reqs)
    wall = time.perf_counter() - t0
    rep = efficiency_report(resp)
    tps = sum(r.gen_length for r in resp) / wall if wall else 0.0
    print(f"cdlm/continuous: TPS={tps:.0f} "
          f"latency={rep['latency_s'] * 1e3:.1f}ms steps={rep['steps']:.1f} "
          f"gen_len={rep['gen_length']:.1f}  ({len(resp)} requests on "
          f"{dev})")
    if args.cache_layout == "paged":
        ps = eng.page_pool_stats()
        print(f"page pool: {ps['peak_pages']:.0f}/{ps['n_pages']:.0f} pages "
              f"peak ({ps['peak_occupancy']:.0%}), "
              f"{ps['preemptions']:.0f} preemptions, "
              f"{ps['stall_rounds']:.0f} stall rounds")


if __name__ == "__main__":
    main()
