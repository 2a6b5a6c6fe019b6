"""Shared assets and CLI plumbing of the PyTorch port's benches: the
jax-free counterpart of ``benchmarks/common.py``.

Assets: the toy teacher, its trajectory dataset, the CDLM student and a
same-size AR model, trained by ``repro_torch.training.trainer`` at the
JAX benches' toy config and budgets, and cached under
``experiments/bench_assets_torch/`` (never the JAX package's
``experiments/bench_assets/``; ``--smoke`` budgets under ``smoke/``).

CLI: :func:`make_parser` (``--smoke``, ``--json``, ``--device``) and
:func:`write_results`; every number is a :func:`record`, the schema of
``benchmarks/common.py`` (``{op, shape, backend, metric, value,
config}``) with the backend read from the torch device ("cuda" or
"cpu")."""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import resolve_device  # noqa: E402
from repro_torch.bridge import init_params  # noqa: E402
from repro_torch.checkpoint import restore, save  # noqa: E402
from repro_torch.configs import CDLMConfig, TrainConfig, get_config  # noqa: E402,E501
from repro_torch.core.block_loop import SamplerSpec  # noqa: E402
from repro_torch.data import Corpus, TaskSpec, score  # noqa: E402
from repro_torch.training import trainer  # noqa: E402

ASSETS = os.path.join(os.path.dirname(__file__), "..", "experiments",
                      "bench_assets_torch")


# ---------------------------------------------------------------------------
# shared CLI + result-record schema
# ---------------------------------------------------------------------------
def make_parser(description=None,
                smoke_help="CI-sized budgets (a few training steps)"):
    """The argparse surface of the port's benches: ``--smoke``, an explicit
    ``--json PATH`` and ``--device`` (the CUDA device unless "cpu")."""
    ap = argparse.ArgumentParser(
        description=description,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--smoke", action="store_true", help=smoke_help)
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write benchmark numbers as JSON to PATH")
    ap.add_argument("--device", default="cuda")
    return ap


def record(op, shape, metric, value, *, device, config=None):
    """One result record of ``benchmarks/common.py``'s schema; the backend
    is the type of the torch ``device`` the number was taken on."""
    return {"op": str(op), "shape": dict(shape or {}),
            "backend": torch.device(device).type, "metric": str(metric),
            "value": float(value), "config": dict(config or {})}


def write_results(path, results):
    """Write a benchmark's ``--json`` artifact (stable key order)."""
    if not path:
        return
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(results, f, indent=2, sort_keys=True)
        f.write("\n")
    print(f"wrote {path}")


# ---------------------------------------------------------------------------
# the toy config, task and budgets (those of benchmarks/common.py)
# ---------------------------------------------------------------------------
CFG = get_config("qwen2-0.5b").reduced(
    n_layers=2, d_model=128, d_ff=256, vocab_size=128, mask_token_id=127)
TASK = TaskSpec("sort", vocab_size=128, prompt_len=10, gen_len=10,
                sort_k=8, sort_range=24)
CDLM_CFG = CDLMConfig(block_size=5, gen_length=10, prompt_length=10,
                      temperatures=(0.0, 0.5))
TEACHER_STEPS = 800
STUDENT_STEPS = 350
SMOKE_STEPS = 4


def corpus():
    return Corpus(TASK, 1024, seed=0)


def _path(name, smoke=False):
    d = os.path.join(ASSETS, "smoke") if smoke else ASSETS
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, name)


def _template(device):
    return init_params(CFG, torch.Generator(device=device).manual_seed(0),
                       device)


def _cached(name, device, smoke, train):
    """Params restored from the asset ``name``, else trained and saved."""
    dev = resolve_device(device)
    p = _path(name, smoke)
    if os.path.exists(p):
        return restore(_template(dev), p)
    params = train(dev)
    save(params, p)
    return params


def _tcfg(steps, lr, smoke):
    return TrainConfig(learning_rate=lr, steps=SMOKE_STEPS if smoke else steps,
                       batch_size=64, remat=False)


def get_teacher(device="cuda", smoke=False, verbose=False):
    return _cached("teacher.npz", device, smoke, lambda dev: (
        trainer.train_teacher(CFG, corpus(), _tcfg(TEACHER_STEPS, 2e-3,
                                                   smoke),
                              verbose=verbose, device=dev)))


def get_ar(device="cuda", smoke=False, verbose=False):
    """The AR reference (Fig. 3): a same-size model trained
    autoregressively."""
    return _cached("ar_baseline.npz", device, smoke, lambda dev: (
        trainer.train_ar(CFG, corpus(), _tcfg(TEACHER_STEPS, 2e-3, smoke),
                         verbose=verbose, device=dev)))


def get_dataset(teacher, smoke=False, verbose=False):
    dev = teacher["embed"]["tok"].device
    p = _path("trajectories.npz", smoke)
    if os.path.exists(p):
        with np.load(p) as d:
            return {k: torch.as_tensor(d[k], device=dev) for k in d.files}
    ds = trainer.collect_dataset(teacher, CFG, CDLM_CFG, corpus(),
                                 n_examples=64 if smoke else 256, batch=64,
                                 verbose=verbose)
    np.savez(p, **{k: v.cpu().numpy() for k, v in ds.items()})
    return ds


def get_student(teacher=None, dataset=None, *, device="cuda", smoke=False,
                weights=None, steps=None, cache_name="student.npz",
                verbose=False):
    """The CDLM student, trained for ``steps`` (STUDENT_STEPS by default)
    under loss ``weights`` (w_distill, w_cons, w_dlm) and cached under
    ``cache_name``."""
    def train(dev):
        t = teacher if teacher is not None else get_teacher(dev, smoke)
        ds = dataset if dataset is not None else get_dataset(t, smoke)
        cdlm = CDLM_CFG
        if weights is not None:
            wd, wc, wm = weights
            cdlm = dataclasses.replace(CDLM_CFG, w_distill=wd, w_cons=wc,
                                       w_dlm=wm)
        return trainer.train_student(t, ds, CFG, cdlm,
                                     _tcfg(steps or STUDENT_STEPS, 5e-4,
                                           smoke),
                                     verbose=verbose)
    return _cached(cache_name, device, smoke, train)


def poisson_trace(n=48, rate_hz=60.0, seed=0, short_frac=0.5,
                  sampled_frac=0.0, *, prompts=None, block=None,
                  gen_len=None):
    """Serving-bench request trace, ``benchmarks/common.py::poisson_trace``
    with its two numpy streams: Poisson arrivals, a ``short_frac`` share
    capped at one block and the rest at the full ``gen_len``, and a
    ``sampled_frac`` share carrying ``SamplingParams`` (temperature 0.7,
    seed = the request's index) drawn from a stream of its own, so that the
    arrivals and caps at a seed do not depend on ``sampled_frac``. The same
    arguments give the JAX function's requests. By default the prompts are
    the toy eval split's and the caps the toy's (block 5, gen 10); a
    full-width bench passes its own ``prompts`` (n, P), ``block`` and
    ``gen_len``."""
    from repro_torch.serving import Request, SamplingParams
    rng = np.random.default_rng(seed)
    srng = np.random.default_rng(seed + 0x5EED)
    if prompts is None:
        prompts = corpus().eval_batch(n)["prompt"]
    arrivals = np.cumsum(rng.exponential(1.0 / rate_hz, n))
    B = block or CDLM_CFG.block_size
    G = gen_len or TASK.gen_len
    reqs = []
    for i in range(n):
        mt = B if rng.random() < short_frac else G
        sp = (SamplingParams(temperature=0.7, seed=i)
              if srng.random() < sampled_frac else None)
        reqs.append(Request(prompt=prompts[i], id=i, max_tokens=int(mt),
                            arrival_s=float(arrivals[i]), params=sp))
    return reqs


def kv_page_bytes(cfg, page_size, dtype=None):
    """KV bytes of one pool page (every attention slot and period, K and
    V), read from the pools ``core/cache.py::init_paged_cache`` makes (on
    the meta device: nothing is allocated)."""
    from repro_torch.core import cache as C
    paged = C.init_paged_cache(cfg, 1, page_size, n_pages=1,
                               page_size=page_size, dtype=dtype,
                               device="meta")
    return sum(t.numel() * t.element_size()
               for slot in paged.slots for k, t in slot.items()
               if k in ("k", "v"))


def eval_sampler(params, sampler_fn, *, n=64, conf_threshold=0.9,
                 block_size=None, temperature=0.0, early_stop=False):
    """Run a sampler over the eval split on the params' device, once to
    warm up and once timed; the Tables 1-2 columns of the JAX
    ``eval_sampler``."""
    dev = params["embed"]["tok"].device
    ev = corpus().eval_batch(n)
    prompts = torch.as_tensor(ev["prompt"], dtype=torch.int64, device=dev)
    spec = SamplerSpec(prompt_len=TASK.prompt_len, gen_len=TASK.gen_len,
                       block_size=block_size or CDLM_CFG.block_size,
                       conf_threshold=conf_threshold,
                       temperature=temperature, early_stop=early_stop)

    def run():
        res = sampler_fn(params, prompts, cfg=CFG, spec=spec)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return res

    run()
    t0 = time.perf_counter()
    res = run()
    dt = time.perf_counter() - t0
    s = score(ev["prompt"], res.tokens.cpu().numpy(), TASK.prompt_len, TASK)
    glen = float(res.gen_lengths.float().mean())
    lat = dt / n
    return {"score": s, "steps": float(res.steps.float().mean()),
            "gen_len": glen, "latency_s": lat,
            "tps": glen / lat if lat else 0.0,
            "calls": int(res.n_model_calls)}
