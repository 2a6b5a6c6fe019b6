"""The paper's four baseline decoders of the port (``fast_dllm``,
``dual_cache``, ``interval_cache``, ``ar``) against the JAX package's, on
the CPU, from the same numpy params, prompts and seeds (``qwen2-0.5b``
reduced, fp32, P=8, G=16, block 8, refresh interval 2): through
``run_block_loop``, greedy (dense logits and fused select) and sampled,
with EOS landing in some lanes; the forward under a ``cache_valid`` mask;
the static ``Engine`` on the same requests (per-request params for the
threshold decoders); the refusals the reference makes; the task scorer;
and the serve CLI's ``--sampler``.

Token equality is the criterion: tokens, steps, ``n_model_calls`` and
``gen_lengths`` exactly. A differing token is a fault of the port, never
a tolerance."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ServeConfig as JaxServeConfig  # noqa: E402
from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.core import block_loop as JB  # noqa: E402
from repro.core import cache as jax_cache  # noqa: E402
from repro.core.sampler import SAMPLERS as JAX_SAMPLERS  # noqa: E402
from repro.data import TaskSpec as JaxTask  # noqa: E402
from repro.data.synthetic import sample_batch as jax_sample_batch  # noqa: E402,E501
from repro.data.synthetic import score as jax_score  # noqa: E402
from repro.data.synthetic import verify as jax_verify  # noqa: E402
from repro.models import forward as jax_forward  # noqa: E402
from repro.models import init_model  # noqa: E402
from repro.serving import Engine as JaxEngine  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import SamplingParams as JaxSP  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import ServeConfig, get_config  # noqa: E402
from repro_torch.core import block_loop as TB  # noqa: E402
from repro_torch.core import cache as C  # noqa: E402
from repro_torch.core import masks  # noqa: E402
from repro_torch.core.sampler import SAMPLERS  # noqa: E402
from repro_torch.data import TaskSpec, score, verify  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import forward  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    ContinuousEngine,
    Engine,
    Request,
    SamplingParams,
)

torch.set_num_threads(2)

JCFG = jax_get_config("qwen2-0.5b").reduced(dtype="float32")
CFG = get_config("qwen2-0.5b").reduced(dtype="float32")
P, G, B, R = 8, 16, 8, 2
TAU = 0.5
EMBED_SCALE = 40.0          # sharpens the tied head: iterations finalize >1
EOS_SCALE = 3.0             # EOS a likelier candidate: some lanes stop
NEW = ("fast_dllm", "dual_cache", "interval_cache", "ar")
THRESHOLD = NEW[:3]


@pytest.fixture(scope="module")
def tree():
    t = jax.tree_util.tree_map(np.asarray,
                               init_model(jax.random.PRNGKey(0), JCFG))
    t["embed"]["tok"] = t["embed"]["tok"] * EMBED_SCALE
    t["embed"]["tok"][CFG.mask_token_id] = 0.0
    t["embed"]["tok"][CFG.eos_token_id] *= EOS_SCALE
    return t


@pytest.fixture(scope="module")
def jparams(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def params(tree):
    return params_from_jax(tree, CFG, "cpu")


def _prompts(n, seed=0):
    return np.random.default_rng(seed).integers(2, CFG.vocab_size - 1,
                                                (n, P), dtype=np.int32)


def _key(jkey):
    return torch.as_tensor(np.asarray(jkey).astype(np.int64))


def _spec_kw(**kw):
    return dict(dict(prompt_len=P, gen_len=G, block_size=B,
                     conf_threshold=TAU, cache_refresh_interval=R), **kw)


def _same_result(got, want):
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.steps.numpy(), np.asarray(want.steps))
    assert got.n_model_calls == int(want.n_model_calls)
    np.testing.assert_array_equal(got.gen_lengths.numpy(),
                                  np.asarray(want.gen_lengths))


# ---------------------------------------------------------------------------
# the decoders through run_block_loop
# ---------------------------------------------------------------------------
CASES = [(n, t, f) for n in THRESHOLD
         for t, f in ((0.0, False), (0.0, True), (0.7, False))]
CASES.append(("ar", 0.0, False))


@pytest.mark.parametrize("name,temperature,fused", CASES,
                         ids=[f"{n}-{'sampled' if t else 'greedy'}"
                              f"{'-fused' if f else ''}"
                              for n, t, f in CASES])
def test_decoder_matches_jax(jparams, params, name, temperature, fused):
    prompts = _prompts(4)
    prompts[1, -1] = CFG.eos_token_id   # the tied head answers EOS to EOS
    kw = _spec_kw(temperature=temperature, fused_select=fused)
    want = JAX_SAMPLERS[name](jparams, jnp.asarray(prompts), cfg=JCFG,
                              spec=JB.SamplerSpec(**kw),
                              key=jax.random.PRNGKey(3))
    got = SAMPLERS[name](params, torch.as_tensor(prompts), cfg=CFG,
                         spec=TB.SamplerSpec(**kw), key=prng.key(3))
    _same_result(got, want)
    # the case decodes what it is meant to: EOS in some lanes, not all
    glen = got.gen_lengths.numpy()
    assert (glen < G).any() and (glen == G).any(), glen
    if name != "ar":
        # some iteration finalized more than one token
        assert (got.steps.numpy() < G).any()


def test_calls_follow_each_policys_accounting(params):
    """Without early stop every block runs until its masks are gone:
    fast_dllm's calls are its iterations, dual_cache's 1 + (blocks - 1) +
    the iterations, interval_cache's 1 + the iterations (its in-loop
    refreshes are not counted, as in the reference), ar's 1 + G."""
    prompts = torch.as_tensor(_prompts(1, seed=1))
    spec = TB.SamplerSpec(**_spec_kw(early_stop=False))
    extra = {"fast_dllm": 0, "dual_cache": spec.n_blocks,
             "interval_cache": 1}
    for name, fn in SAMPLERS.items():
        res = fn(params, prompts, cfg=CFG, spec=spec)
        iters = int(res.steps[0])
        if name in extra:
            assert res.n_model_calls == iters + extra[name], name
        elif name == "ar":
            assert (res.n_model_calls, iters) == (1 + G, G)


def test_forward_cache_valid_matches_jax():
    """The block forward of the approx policies: a stale whole-canvas cache
    whose active-block rows are invalid, against the JAX forward (the
    init's own scale: logits of order 1)."""
    tree = jax.tree_util.tree_map(np.asarray,
                                  init_model(jax.random.PRNGKey(1), JCFG))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    params = params_from_jax(tree, CFG, "cpu")
    rng = np.random.default_rng(7)
    b, T, start = 2, P + G, P + B
    canvas = rng.integers(2, CFG.vocab_size - 1, (b, T)).astype(np.int32)
    valid = ~((np.arange(T) >= start) & (np.arange(T) < start + B))
    jc = jax_cache.init_cache(JCFG, b, T, dtype=JCFG.dtype)
    jout = jax_forward(jparams, jnp.asarray(canvas), cfg=JCFG,
                       mode=masks.BIDIRECTIONAL, prompt_len=P, block_size=B)
    jc = jax_cache.commit(jc, jout.emissions, 0)
    tc = C.init_cache(CFG, b, T, device="cpu")
    tout = forward(params, torch.as_tensor(canvas), cfg=CFG, device="cpu",
                   mode=masks.BIDIRECTIONAL, prompt_len=P, block_size=B)
    C.commit(tc, tout.emissions, 0)
    blk = canvas[:, start:start + B]
    blk = np.where(rng.random(blk.shape) < 0.5, CFG.mask_token_id, blk)
    want = jax_forward(jparams, jnp.asarray(blk), cfg=JCFG,
                       mode=masks.BIDIRECTIONAL, prompt_len=P, block_size=B,
                       positions=start + jnp.arange(B), cache=jc,
                       cache_len=start, cache_valid=jnp.asarray(valid))
    got = forward(params, torch.as_tensor(blk), cfg=CFG, device="cpu",
                  mode=masks.BIDIRECTIONAL, prompt_len=P, block_size=B,
                  positions=start + torch.arange(B), cache=tc,
                  cache_len=start, cache_valid=torch.as_tensor(valid))
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits),
                               atol=1e-5, rtol=1e-5)
    for g, w in zip(got.emissions, want.emissions):
        for k in ("k", "v"):
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]),
                                       atol=1e-5, rtol=1e-5)
    # the mask is read: the same forward seeing the stale block rows differs
    stale = forward(params, torch.as_tensor(blk), cfg=CFG, device="cpu",
                    mode=masks.BIDIRECTIONAL, prompt_len=P, block_size=B,
                    positions=start + torch.arange(B), cache=tc,
                    cache_len=start,
                    cache_valid=torch.ones(T, dtype=torch.bool))
    assert not torch.allclose(stale.logits, got.logits)


# ---------------------------------------------------------------------------
# the static engine
# ---------------------------------------------------------------------------
def _serve(cls, **kw):
    base = dict(max_batch=2, block_size=B, gen_length=G, conf_threshold=TAU,
                cache_refresh_interval=R)
    return cls(**dict(base, **kw))


def _trace(cls, sp_cls, per_request, n=5):
    """Bare requests, or (per_request) greedy, sampled and bare ones with
    mixed caps, one per-request threshold and one EOS override."""
    prompts = _prompts(n, seed=4)
    if not per_request:
        return [cls(prompt=p, id=i) for i, p in enumerate(prompts)]
    params = [None, sp_cls(temperature=0.7, seed=11),
              sp_cls(conf_threshold=0.3), sp_cls(temperature=1.2, seed=5,
                                                 eos_token_id=7),
              sp_cls(temperature=0.9)][:n]
    caps = [None, 2 * B, None, None, B][:n]
    return [cls(prompt=p, id=i, max_tokens=c, params=sp)
            for i, (p, c, sp) in enumerate(zip(prompts, caps, params))]


@pytest.mark.parametrize("name", NEW)
def test_static_engine_matches_jax(jparams, params, name):
    per_request = name != "ar"
    jeng = JaxEngine(jparams, JCFG, _serve(JaxServeConfig, sampler=name),
                     prompt_len=P)
    eng = Engine(params, CFG, _serve(ServeConfig, sampler=name),
                 prompt_len=P, device="cpu")
    key = jax.random.PRNGKey(21)
    want = jeng.generate(_trace(JaxRequest, JaxSP, per_request), key=key)
    got = eng.generate(_trace(Request, SamplingParams, per_request),
                       key=_key(key))
    got, want = {o.id: o for o in got}, {o.id: o for o in want}
    assert sorted(got) == sorted(want)
    for rid, w in want.items():
        g = got[rid]
        np.testing.assert_array_equal(g.tokens, np.asarray(w.tokens), rid)
        assert (g.steps, g.gen_length, g.finish_reason) == \
            (w.steps, w.gen_length, w.finish_reason), rid


# ---------------------------------------------------------------------------
# refusals, as the reference makes them
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["paged-fast_dllm", "paged-dual_cache",
                                  "paged-interval_cache", "paged-ar",
                                  "continuous-engine", "ar-request-knobs"])
def test_refusals(jparams, params, case):
    prompts = torch.as_tensor(_prompts(1))
    if case.startswith("paged-"):
        name = case[len("paged-"):]
        spec = TB.SamplerSpec(**_spec_kw(cache_layout="paged"))
        with pytest.raises(ValueError, match="requires the 'exact-commit'"):
            SAMPLERS[name](params, prompts, cfg=CFG, spec=spec)
        with pytest.raises(ValueError, match="requires the 'exact-commit'"):
            JAX_SAMPLERS[name](jparams, jnp.asarray(prompts.numpy()),
                               cfg=JCFG, spec=JB.SamplerSpec(**_spec_kw(
                                   cache_layout="paged")))
    elif case == "continuous-engine":
        for name in NEW:
            with pytest.raises(ValueError, match="requires the 'cdlm'"):
                ContinuousEngine(params, CFG, _serve(
                    ServeConfig, sampler=name, scheduler="continuous"),
                    prompt_len=P, device="cpu")
    else:
        eng = Engine(params, CFG, _serve(ServeConfig, sampler="ar"),
                     prompt_len=P, device="cpu")
        with pytest.raises(ValueError, match="threshold-finalize"):
            eng.add_request(Request(prompt=_prompts(1)[0], params=(
                SamplingParams(temperature=0.7))))


# ---------------------------------------------------------------------------
# the task scorer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("task", ["sort", "add"])
def test_scorer_matches_jax(task):
    kw = dict(vocab_size=128, prompt_len=14, gen_len=10)
    spec, jspec = TaskSpec(task, **kw), JaxTask(task, **kw)
    rng = np.random.default_rng(3)
    batch = jax_sample_batch(np.random.default_rng(3), jspec, 12)
    prompts, answers = batch["prompt"], batch["answer"].copy()
    # corrupt some answers, drop the EOS of others, garble a prompt
    answers[1::3, 0] += 1
    answers[2::4] = np.where(answers[2::4] == 1, 0, answers[2::4])
    prompts[5, :] = rng.integers(10, 40, prompts.shape[1])
    tokens = np.concatenate([prompts, answers], 1)
    for p, a in zip(prompts, answers):
        assert verify(p, a, spec) == jax_verify(p, a, jspec)
    s = score(prompts, tokens, kw["prompt_len"], spec)
    assert s == jax_score(prompts, tokens, kw["prompt_len"], jspec)
    assert 0.0 < s < 1.0


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["ar", "dual_cache"])
def test_serve_cli_sampler(capsys, name):
    serve_cli.main(["--reduced", "--device", "cpu", "--sampler", name,
                    "--prompt-len", "8", "--gen-length", "16",
                    "--block-size", "8", "--requests", "3", "--batch", "2"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"{name}/static: TPS="), line
    assert "steps=" in line and "gen_len=" in line


def test_every_sampler_is_served():
    assert list(SAMPLERS) == list(JAX_SAMPLERS)
    assert set(TB.PORTED) == {(s.cache_policy, s.finalize)
                              for s in TB.STRATEGIES.values()}
    spec = TB.SamplerSpec(prompt_len=P, gen_len=G, block_size=B)
    assert spec.cache_refresh_interval == \
        JB.SamplerSpec(prompt_len=P, gen_len=G,
                       block_size=B).cache_refresh_interval


# ---------------------------------------------------------------------------
# the Tables 1-2 bench's plumbing
# ---------------------------------------------------------------------------
def test_bench_toy_half_on_the_cpu(tmp_path, monkeypatch, capsys):
    """``benchmarks/bench_main_results_torch.py --device cpu --toy
    --smoke``: every decoder's row, each record in the JAX benches' schema
    with the torch device as its backend, and the assets cached under the
    given directory."""
    import json

    from benchmarks import bench_main_results_torch as bench
    from benchmarks import common as jax_common
    from benchmarks import common_torch
    monkeypatch.setattr(common_torch, "ASSETS", str(tmp_path / "assets"))
    out = tmp_path / "toy.json"
    assert bench.main(["--device", "cpu", "--toy", "--smoke", "--json",
                       str(out)]) == 0
    recs = json.loads(out.read_text())
    assert {r["op"] for r in recs} == {f"main_results_toy/{k}"
                                       for k in SAMPLERS}
    want = jax_common.record("op", {"n": 1}, "tps", 1.0, backend="cpu")
    got = common_torch.record("op", {"n": 1}, "tps", 1.0, device="cpu")
    assert got == want
    assert all(r["backend"] == "cpu" for r in recs)
    assert sorted(p.name for p in (tmp_path / "assets" / "smoke").iterdir()) \
        == ["ar_baseline.npz", "student.npz", "teacher.npz",
            "trajectories.npz"]
    assert "AR baseline" in capsys.readouterr().out
