"""HTTP serving smoke of the PyTorch port: boot ``repro_torch``'s stdlib
frontend on an ephemeral loopback port over a random-init continuous
engine (dense-logits decode, so it takes sampled requests), send a greedy
and a seeded sampled completion, each streamed and not, and assert that
the streamed chunks reassemble to the non-streamed ``token_ids`` and that
both equal the static ``Engine.generate`` of the same request on an
identical engine. Then ``/healthz`` and ``/metrics``.

    PYTHONPATH=src python benchmarks/serve_smoke_torch.py            # CUDA
    PYTHONPATH=src python benchmarks/serve_smoke_torch.py --device cpu

Imports nothing of JAX: the port's counterpart of ``serve_smoke.py``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import urllib.request

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import resolve_device  # noqa: E402
from repro_torch.bridge import init_params  # noqa: E402
from repro_torch.configs import ServeConfig, get_config  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    Engine,
    Request,
    SamplingParams,
    make_engine,
)
from repro_torch.serving.server import serve_http  # noqa: E402

P, G, B = 8, 16, 4
CFG = get_config("qwen2-0.5b").reduced(dtype="float32")
SERVE = ServeConfig(max_batch=2, block_size=B, gen_length=G, sampler="cdlm",
                    conf_threshold=0.5, scheduler="continuous")
BODIES = {"greedy": {}, "sampled": {"temperature": 0.7, "seed": 1234}}


def _post(base, body):
    req = urllib.request.Request(
        f"{base}/v1/completions", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=300)


def _streamed(base, body):
    ids, chunks = [], 0
    with _post(base, dict(body, stream=True)) as r:
        for raw in r:
            line = raw.decode().strip()
            if not line.startswith("data: "):
                continue
            data = line[len("data: "):]
            if data == "[DONE]":
                break
            ids.extend(json.loads(data)["choices"][0]["token_ids"])
            chunks += 1
    return ids, chunks


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    params = init_params(CFG, torch.Generator(device=dev).manual_seed(0), dev)
    rng = np.random.default_rng(0)
    prompt = rng.integers(2, CFG.mask_token_id, P)

    eng = make_engine(params, CFG, SERVE, prompt_len=P, device=dev)
    eng.warmup(per_request=True)
    server = serve_http(eng, "127.0.0.1", 0, block=False)
    base = "http://127.0.0.1:%d" % server.server_address[1]
    try:
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            assert json.load(r)["status"] == "ok"
        ref_eng = Engine(params, CFG, SERVE, prompt_len=P, device=dev)
        for name, body in BODIES.items():
            sp = SamplingParams(**body) if body else None
            ref = ref_eng.generate([Request(prompt=prompt, id=0,
                                            params=sp)])[0]
            want = np.asarray(ref.tokens)[:ref.gen_length].tolist()
            full_body = dict(body, prompt=prompt.tolist())
            with _post(base, full_body) as r:
                full = json.load(r)["choices"][0]["token_ids"]
            streamed, chunks = _streamed(base, full_body)
            assert full == want, (name, full, want)
            assert streamed == full, (name, streamed, full)
            print(f"{name}: {len(full)} tokens, non-streamed == streamed "
                  f"({chunks} block chunks) == Engine.generate")
        with urllib.request.urlopen(f"{base}/metrics", timeout=30) as r:
            metrics = r.read().decode()
        n = 2 * len(BODIES)
        assert f"cdlm_requests_completed_total {n}" in metrics, metrics
        assert "cdlm_lanes_peak_lanes" in metrics, metrics
        print(f"metrics: requests_completed_total={n}, lane gauges exported")
    finally:
        server.shutdown()
    print("serve smoke OK")


if __name__ == "__main__":
    main()
