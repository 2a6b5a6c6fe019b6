"""Serving CLI of the port: any of the paper's six decoders through the
static engine, or CDLM decoding through the continuous one, on a local
batch of requests or over HTTP.

    PYTHONPATH=src python -m repro_torch.launch.serve
    PYTHONPATH=src python -m repro_torch.launch.serve --sampler ar \\
        --reduced --device cpu --prompt-len 16 --gen-length 32 --block-size 8
    PYTHONPATH=src python -m repro_torch.launch.serve --config qwen2-0.5b \\
        --reduced --device cpu --prompt-len 16 --gen-length 32 --block-size 8
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \\
        --prompt-len 16 --gen-length 32 --block-size 8 \\
        --scheduler continuous --cache-layout paged --pool-pages 8
    PYTHONPATH=src python -m repro_torch.launch.serve --scheduler continuous \\
        --http --port 8000

Params come from ``--ckpt`` (an npz written by the JAX package's
``checkpoint/io.py``, converted by ``repro_torch.bridge``) or, without it,
from a seeded random init on the device. Without ``--http``, prompts are
random tokens drawn from ``--seed`` and the CLI prints one
``<sampler>/<scheduler>: TPS=... latency=... steps=... gen_len=...`` line,
as the JAX package's ``launch/serve.py`` does, and on the continuous paged
layout its ``page pool:`` occupancy line. With ``--http`` the engine is served by
``repro_torch.serving.server`` (``POST /v1/completions`` with SSE
streaming, ``GET /healthz``, ``GET /metrics``) until interrupted; the
first line printed names the bound address (``--port 0`` binds a free
port). Everything runs on the CUDA device unless ``--device cpu``.
An encoder-decoder config (whisper-base) is refused: its requests carry
frame embeddings, which the CLI's token prompts cannot; internvl2-1b
serves its text path (no prefix).
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
    ap.add_argument("--sampler", default="cdlm",
                    choices=["vanilla", "fast_dllm", "dual_cache",
                             "interval_cache", "cdlm", "ar"])
    ap.add_argument("--scheduler", default="static",
                    choices=["static", "continuous"],
                    help="continuous = slot-based block-level batching "
                         "(cdlm only)")
    ap.add_argument("--fused-select", action="store_true",
                    help="fused unembed + online-softmax candidate "
                         "selection (the select kernel): decode skips the "
                         "lm_head and never builds (b, ., V) logits; "
                         "greedy decoding only")
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
                    help="continuous paged layout: page-pool size in pages "
                         "(default: dense-equivalent capacity)")
    ap.add_argument("--http", action="store_true",
                    help="serve over HTTP (/v1/completions with SSE "
                         "streaming, /healthz, /metrics) instead of "
                         "replaying a local request batch")
    ap.add_argument("--host", default=None,
                    help="HTTP bind host (default: ServeConfig.http_host)")
    ap.add_argument("--port", type=int, default=None,
                    help="HTTP bind port (default: ServeConfig.http_port; "
                         "0 binds a free port)")
    args = ap.parse_args(argv)

    from repro_torch import resolve_device
    from repro_torch.bridge import init_params, params_from_jax
    from repro_torch.configs import ServeConfig, get_config
    from repro_torch.serving import Request, efficiency_report, make_engine

    cfg = get_config(args.config)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.is_encoder_decoder:
        raise ValueError(
            f"{cfg.name}: its requests need frame embeddings "
            "(GenerationRequest.extras['encoder_embeds']), which a token "
            "prompt cannot give; serve it through repro_torch.serving.Engine")
    dev = resolve_device(args.device)
    if args.ckpt:
        with np.load(args.ckpt) as data:
            params = params_from_jax(data, cfg, dev, args.dtype)
    else:
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        params = init_params(cfg, gen, dev, args.dtype)
    serve = ServeConfig(max_batch=args.batch, block_size=args.block_size,
                        gen_length=args.gen_length,
                        sampler=args.sampler,
                        conf_threshold=args.threshold,
                        scheduler=args.scheduler,
                        cache_layout=args.cache_layout,
                        page_pool_pages=args.pool_pages,
                        fused_select=args.fused_select)
    eng = make_engine(params, cfg, serve, prompt_len=args.prompt_len,
                      device=dev)
    if args.http:
        from repro_torch.serving.server import serve_http
        host = args.host if args.host is not None else serve.http_host
        port = args.port if args.port is not None else serve.http_port
        eng.warmup(per_request=True)
        server = serve_http(eng, host, port, block=False)
        print(f"serving /v1/completions on http://{host}:"
              f"{server.server_address[1]} (prompt_len={args.prompt_len}, "
              f"scheduler={args.scheduler}, {dev}) - Ctrl-C to stop",
              flush=True)
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            pass
        finally:
            server.shutdown()
        return
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
    # wall-clock TPS is comparable across schedulers; latency_s is not
    # (compute share for static, arrival->completion for continuous)
    tps = sum(r.gen_length for r in resp) / wall if wall else 0.0
    print(f"{args.sampler}/{args.scheduler}: TPS={tps:.0f} "
          f"latency={rep['latency_s'] * 1e3:.1f}ms steps={rep['steps']:.1f} "
          f"gen_len={rep['gen_length']:.1f}  ({len(resp)} requests on "
          f"{dev})")
    if args.cache_layout == "paged" and args.scheduler == "continuous":
        ps = eng.page_pool_stats()
        print(f"page pool: {ps['peak_pages']:.0f}/{ps['n_pages']:.0f} pages "
              f"peak ({ps['peak_occupancy']:.0%}), "
              f"{ps['preemptions']:.0f} preemptions, "
              f"{ps['stall_rounds']:.0f} stall rounds")


if __name__ == "__main__":
    main()
