"""The port's bench plumbing against the JAX benches', on the CPU: the
serving trace (``poisson_trace``), a page's KV bytes, ``eval_sampler`` on
the toy config's params carried across by ``bridge``, and the serving
bench's part (b) with every arrival at 0 (so the host's speed decides
nothing) against the JAX engines; then every table bench, and the runner
``benchmarks/run_torch.py --device cpu --smoke``, run to their end."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks import bench_serving as jax_bench_serving  # noqa: E402
from benchmarks import common as jax_common  # noqa: E402
from benchmarks import common_torch as common  # noqa: E402
from repro.configs.base import ServeConfig as JaxServeConfig  # noqa: E402
from repro.core.sampler import SAMPLERS as JAX_SAMPLERS  # noqa: E402
from repro.core.sampler import SamplerSpec as JaxSpec  # noqa: E402
from repro.models import init_model  # noqa: E402
from repro.serving import ContinuousEngine as JaxContinuous  # noqa: E402
from repro.serving import Engine as JaxEngine  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.core.sampler import SAMPLERS  # noqa: E402

torch.set_num_threads(2)

EMBED_SCALE = 40.0      # sharpens the tied head: iterations finalize > 1


@pytest.fixture(scope="module")
def tree():
    t = jax.tree_util.tree_map(np.asarray,
                               init_model(jax.random.PRNGKey(0),
                                          jax_common.CFG))
    t["embed"]["tok"] = t["embed"]["tok"] * EMBED_SCALE
    t["embed"]["tok"][jax_common.CFG.mask_token_id] = 0.0
    return t


@pytest.fixture(scope="module")
def jparams(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def tparams(tree):
    return params_from_jax(tree, common.CFG, device="cpu")


@pytest.mark.parametrize("sampled_frac", [0.0, 0.5])
def test_poisson_trace_equals_jax(sampled_frac):
    got = common.poisson_trace(n=48, rate_hz=60.0, seed=3,
                               sampled_frac=sampled_frac)
    want = jax_common.poisson_trace(n=48, rate_hz=60.0, seed=3,
                                    sampled_frac=sampled_frac)
    assert len(got) == len(want) == 48
    for g, w in zip(got, want):
        assert (g.id, g.max_tokens, g.arrival_s) == \
            (w.id, w.max_tokens, w.arrival_s)
        np.testing.assert_array_equal(np.asarray(g.prompt),
                                      np.asarray(w.prompt))
        assert (g.params is None) == (w.params is None)
        if g.params is not None:
            assert (g.params.temperature, g.params.seed) == \
                (w.params.temperature, w.params.seed)
    if sampled_frac:
        assert any(g.params is not None for g in got)
    # the full-width form keeps the streams and takes the given prompts
    prompts = np.arange(48 * 3).reshape(48, 3)
    full = common.poisson_trace(n=48, rate_hz=60.0, seed=3, prompts=prompts,
                                block=32, gen_len=256,
                                sampled_frac=sampled_frac)
    assert [r.arrival_s for r in full] == [r.arrival_s for r in got]
    assert [r.max_tokens for r in full] == [
        32 if r.max_tokens == common.CDLM_CFG.block_size else 256
        for r in got]


def test_kv_page_bytes_equals_jax():
    assert common.kv_page_bytes(common.CFG, common.CDLM_CFG.block_size,
                                common.CFG.dtype) == \
        jax_bench_serving._kv_page_bytes()


@pytest.mark.parametrize("name", ["vanilla", "fast_dllm", "cdlm"])
def test_eval_sampler_equals_jax(jparams, tparams, name):
    kw = dict(n=16, conf_threshold=0.9)
    got = common.eval_sampler(tparams, SAMPLERS[name], **kw)
    want = jax_common.eval_sampler(jparams, JAX_SAMPLERS[name], **kw)
    for k in ("score", "steps", "gen_len", "calls"):
        assert got[k] == want[k], (k, got[k], want[k])
    # the tokens, through the same spec as eval_sampler's
    ev = jax_common.corpus().eval_batch(16)
    spec = dict(prompt_len=common.TASK.prompt_len,
                gen_len=common.TASK.gen_len,
                block_size=common.CDLM_CFG.block_size, conf_threshold=0.9)
    from repro_torch.core.block_loop import SamplerSpec
    t = SAMPLERS[name](tparams, torch.as_tensor(ev["prompt"],
                                                dtype=torch.int64),
                       cfg=common.CFG, spec=SamplerSpec(**spec))
    j = JAX_SAMPLERS[name](jparams, jnp.asarray(ev["prompt"]),
                           cfg=jax_common.CFG, spec=JaxSpec(**spec))
    np.testing.assert_array_equal(t.tokens.numpy(), np.asarray(j.tokens))


def _jax_serve(jparams, reqs, serve_kw, static):
    if static:
        eng = JaxEngine(jparams, jax_common.CFG,
                        JaxServeConfig(scheduler="static", **serve_kw),
                        prompt_len=common.TASK.prompt_len)
        out = []
        B = serve_kw["max_batch"]
        for i in range(0, len(reqs), B):
            out += eng.generate(reqs[i:i + B])
        return {o.id: o for o in out}, eng
    eng = JaxContinuous(jparams, jax_common.CFG,
                        JaxServeConfig(scheduler="continuous", **serve_kw),
                        prompt_len=common.TASK.prompt_len)
    return {o.id: o for o in eng.generate(reqs)}, eng


def _zero(reqs):
    for r in reqs:
        r.arrival_s = 0.0
    return reqs


def test_serving_bench_toy_part_equals_the_jax_engines(jparams, tparams):
    """Part (b) at 12 requests, 4 lanes, a budget of 12 pages, every arrival
    at 0: tokens per request (static and continuous; dense and paged),
    peak lanes, stalls and preemptions equal the JAX engines' on the JAX
    trace of the same seeds."""
    from benchmarks import bench_serving_torch as bench
    records = []
    res = bench.run_toy(torch.device("cpu"), records, params=tparams,
                        n_requests=12, max_batch=4, rate_hz=None,
                        budget_pages=12)
    B, G = common.CDLM_CFG.block_size, common.TASK.gen_len
    kw = dict(block_size=B, gen_length=G, sampler="cdlm", conf_threshold=0.9)
    sched = res["schedulers"][0]
    reqs = _zero(jax_common.poisson_trace(n=12, rate_hz=1.0, seed=0))
    for name, static in (("static", True), ("continuous", False)):
        want, eng = _jax_serve(jparams, reqs, dict(kw, max_batch=4), static)
        got = sched["outputs"][name]
        assert sorted(got) == sorted(want)
        for rid in want:
            np.testing.assert_array_equal(got[rid].tokens,
                                          np.asarray(want[rid].tokens))
            assert got[rid].steps == want[rid].steps
        if not static:
            assert sched[name]["peak_lanes"] == \
                eng.concurrency_stats()["peak_lanes"]
    lay = res["layouts"]
    reqs = _zero(jax_common.poisson_trace(n=8, rate_hz=1.0, seed=1))
    n_tables = -(-(common.TASK.prompt_len + G) // B)
    dense_lanes = 12 // n_tables
    for name, extra in (("dense", dict(max_batch=dense_lanes)),
                        ("paged", dict(max_batch=2 * dense_lanes,
                                       cache_layout="paged",
                                       page_pool_pages=12))):
        want, eng = _jax_serve(jparams, reqs, dict(kw, **extra), False)
        got = lay[name]
        for rid in want:
            np.testing.assert_array_equal(got["outputs"][rid].tokens,
                                          np.asarray(want[rid].tokens))
        assert got["peak_lanes"] == eng.concurrency_stats()["peak_lanes"]
        pool = eng.page_pool_stats()
        if name == "paged":
            for k in ("stall_rounds", "preemptions", "peak_pages"):
                assert got["pool"][k] == pool[k], k
    assert {r["backend"] for r in records} == {"cpu"}


@pytest.fixture(scope="module")
def smoke_assets(tmp_path_factory):
    """The smoke-budget toy assets under a directory of this module's."""
    mp = pytest.MonkeyPatch()
    mp.setattr(common, "ASSETS", str(tmp_path_factory.mktemp("assets")))
    yield common.ASSETS
    mp.undo()


@pytest.mark.parametrize("name", ["step_truncation", "conf_threshold",
                                  "block_size", "loss_weights"])
def test_table_bench_runs_to_its_end(smoke_assets, tmp_path, name):
    import importlib
    mod = importlib.import_module(f"benchmarks.bench_{name}_torch")
    out = tmp_path / f"{name}.json"
    assert mod.main(["--device", "cpu", "--smoke", "--json", str(out)]) == 0
    rows = json.loads(out.read_text())
    assert rows and all(r["name"].startswith(f"{name}/") for r in rows)
    if name == "loss_weights":
        cached = sorted(p.name for p in (
            __import__("pathlib").Path(smoke_assets) / "smoke").iterdir())
        assert [n for n in cached if n.startswith("student_w")] == sorted(
            f"student_w{w[0]}_{w[1]}_{w[2]}.npz" for _, w in mod.VARIANTS)


@pytest.mark.parametrize("name", ["arithmetic_intensity", "kernels",
                                  "main_results", "step_truncation",
                                  "conf_threshold", "block_size",
                                  "loss_weights", "serving", "all"])
def test_runner_smoke_on_the_cpu(smoke_assets, capsys, name):
    from benchmarks import run_torch
    assert run_torch.main(["--device", "cpu", "--smoke", name]) == 0
    out = capsys.readouterr().out
    if name == "all":
        csv = out.split("name,us_per_call,derived\n", 1)[1]
        names = {line.split(",")[0].split("/")[0]
                 for line in csv.splitlines() if "," in line}
        assert {"ai_model", "main_results", "step_truncation",
                "conf_threshold", "block_size", "loss_weights",
                "serving_toy"} <= names
