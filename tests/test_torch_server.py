"""The port's HTTP frontend (``repro_torch.serving.server``) over loopback
on the CPU: streamed chunks reassemble to the non-streamed ``token_ids``,
which equal the engine's ``generate`` (greedy and seeded-sampled, both
schedulers); a sampled request to a ``fused_select`` engine and a prompt
of the wrong length get 400; ``/healthz`` turns 500 once ``step()``
raises; ``/metrics`` carries the request counters and the engine's
phases. Then the serve CLI's ``--http --port 0`` in a subprocess and
``benchmarks/serve_smoke_torch.py``. Every comparison is exact (token
ids)."""
import json
import os
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.bridge import init_params  # noqa: E402
from repro_torch.configs import ServeConfig, get_config  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    Request,
    SamplingParams,
    make_engine,
)
from repro_torch.serving.engine import PHASES  # noqa: E402
from repro_torch.serving.server import serve_http  # noqa: E402

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
CFG = get_config("qwen2-0.5b").reduced(dtype="float32")
P, G, B = 8, 16, 4
BODIES = {"greedy": {}, "sampled": {"temperature": 0.8, "seed": 77}}


@pytest.fixture(scope="module")
def params():
    p = init_params(CFG, torch.Generator().manual_seed(0), "cpu")
    p["embed"]["tok"] *= 40.0          # a sharp head: iterations finalize >1
    p["embed"]["tok"][CFG.mask_token_id] = 0.0
    return p


def _serve(**kw):
    base = dict(max_batch=2, block_size=B, gen_length=G, conf_threshold=0.5,
                scheduler="continuous")
    return ServeConfig(**dict(base, **kw))


def _prompt(seed=0):
    return np.random.default_rng(seed).integers(2, CFG.vocab_size - 1, P)


def _post(base, body):
    req = urllib.request.Request(
        f"{base}/v1/completions", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=120)


def _stream(base, body):
    ids, done = [], False
    with _post(base, dict(body, stream=True)) as r:
        for raw in r:
            line = raw.decode().strip()
            if line == "data: [DONE]":
                done = True
                break
            if line.startswith("data: "):
                ids.extend(json.loads(line[6:])["choices"][0]["token_ids"])
    assert done
    return ids


@pytest.fixture
def server(params, request):
    eng = make_engine(params, CFG, _serve(**request.param), P, device="cpu")
    eng.warmup(per_request=True)
    srv = serve_http(eng, "127.0.0.1", 0, block=False)
    yield eng, "http://127.0.0.1:%d" % srv.server_address[1]
    srv.shutdown()


@pytest.mark.parametrize("server", [{}, {"scheduler": "static"}],
                         ids=["continuous", "static"], indirect=True)
def test_streamed_equals_full_equals_generate(params, server):
    eng, base = server
    for i, (name, body) in enumerate(BODIES.items()):
        prompt = _prompt(i)
        ref = make_engine(params, CFG, _serve(scheduler=eng.serve.scheduler),
                          P, device="cpu").generate([Request(
                              prompt=prompt, id=0,
                              params=SamplingParams(**body) if body
                              else None)])[0]
        want = ref.tokens[:ref.gen_length].tolist()
        full_body = dict(body, prompt=prompt.tolist())
        with _post(base, full_body) as r:
            full = json.load(r)
        assert full["choices"][0]["token_ids"] == want, name
        assert full["usage"]["steps"] == ref.steps
        assert _stream(base, full_body) == want, name
    with urllib.request.urlopen(f"{base}/metrics", timeout=30) as r:
        metrics = r.read().decode()
    assert "cdlm_requests_total 4" in metrics
    assert "cdlm_requests_completed_total 4" in metrics


@pytest.mark.parametrize("server", [{"fused_select": True}],
                         ids=["fused"], indirect=True)
def test_bad_requests_get_400(server):
    _, base = server
    bodies = [{"prompt": _prompt().tolist(), "temperature": 0.7},
              {"prompt": _prompt().tolist()[:P - 1]}]
    for body in bodies:
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(base, body)
        assert err.value.code == 400
    with _post(base, {"prompt": _prompt().tolist()}) as r:   # greedy: ok
        assert len(json.load(r)["choices"][0]["token_ids"]) > 0


@pytest.mark.parametrize("server", [{}], ids=["continuous"], indirect=True)
def test_healthz_turns_500_after_step_raises(server):
    eng, base = server
    with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
        assert r.status == 200

    def broken():
        raise RuntimeError("decode failed")

    eng.step = broken
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(base, {"prompt": _prompt().tolist()})
    assert err.value.code == 503
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(f"{base}/healthz", timeout=30)
    assert err.value.code == 500
    assert "decode failed" in json.load(err.value)["error"]


@pytest.mark.parametrize("server", [{}], ids=["continuous"], indirect=True)
def test_metrics_export_the_engine_phases(server):
    eng, base = server
    with _post(base, {"prompt": _prompt().tolist()}) as r:
        assert json.load(r)["choices"][0]["token_ids"]
    with urllib.request.urlopen(f"{base}/metrics", timeout=30) as r:
        metrics = r.read().decode()
    got = dict(line.rsplit(" ", 1) for line in metrics.splitlines()
               if line.startswith("cdlm_engine_phase"))
    stats = eng.phase_stats()
    assert set(stats) == set(PHASES)
    for name, st in stats.items():
        assert float(got[f'cdlm_engine_phase_total{{phase="{name}"}}']
                     ) == st["count"]
        assert float(got[f'cdlm_engine_phase_seconds_total{{phase="{name}"}}'
                         ]) == st["seconds"]
    assert stats["engine.refine"]["count"] == eng.call_counts()["refine"] > 0
    assert "# TYPE cdlm_engine_phase_seconds_total counter" in metrics


def test_serve_cli_serves_http_on_port_0():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--http",
         "--port", "0", "--reduced", "--device", "cpu", "--prompt-len",
         str(P), "--gen-length", str(G), "--block-size", str(B), "--batch",
         "2", "--scheduler", "continuous"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving /v1/completions on http://"), (
            line, proc.stderr.read() if proc.poll() is not None else "")
        base = line.split(" on ")[1].split(" ")[0]
        t0 = time.time()
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            assert json.load(r)["status"] == "ok"
        body = {"prompt": _prompt().tolist(), "temperature": 0.9, "seed": 3}
        with _post(base, body) as r:
            full = json.load(r)["choices"][0]["token_ids"]
        assert _stream(base, body) == full and len(full) > 0
        assert time.time() - t0 < 120
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_serve_smoke_script_on_cpu(capsys):
    sys.path.insert(0, str(ROOT))
    try:
        from benchmarks import serve_smoke_torch
    finally:
        sys.path.remove(str(ROOT))
    serve_smoke_torch.main(["--device", "cpu"])
    assert capsys.readouterr().out.strip().endswith("serve smoke OK")
