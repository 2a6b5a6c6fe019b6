"""Sampled decoding of the port against the JAX package's, on the CPU, from
the same numpy params, prompts and seeds (``qwen2-0.5b`` reduced, fp32):
the sampled and per-lane candidate selection, ``cdlm`` through
``run_block_loop`` (dense and paged, greedy, scalar-sampled and per-lane
mixed), the static ``Engine`` (greedy through fused select, a sampled
engine default, per-request mixed params), the continuous engine with
``fused_select=False`` (greedy and sampled lanes mixed, both layouts, and
a tight pool that preempts), and the collector at the augmentation
temperatures through the trainer's key chain. Then the port's own
invariants: a sampled lane decodes alone as it does batched (in the
continuous engine and the static one), and its seed sets its stream.

Token equality is the criterion: tokens, steps, ``gen_length``,
``finish_reason`` and call counts exactly; candidate indices exactly;
confidences within 1e-6 relative (fp32 softmax, sums in another order)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import CDLMConfig as JaxCDLM  # noqa: E402
from repro.configs.base import ServeConfig as JaxServeConfig  # noqa: E402
from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.core import block_loop as JB  # noqa: E402
from repro.core import diffusion as jax_d  # noqa: E402
from repro.data import Corpus as JaxCorpus  # noqa: E402
from repro.data import TaskSpec as JaxTask  # noqa: E402
from repro.models import init_model  # noqa: E402
from repro.serving import ContinuousEngine as JaxContinuous  # noqa: E402
from repro.serving import Engine as JaxEngine  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import SamplingParams as JaxSP  # noqa: E402
from repro.training import trainer as jax_trainer  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import CDLMConfig, ServeConfig, get_config  # noqa: E402,E501
from repro_torch.core import block_loop as TB  # noqa: E402
from repro_torch.core import diffusion as D  # noqa: E402
from repro_torch.core.sampler import SAMPLERS  # noqa: E402
from repro_torch.data import Corpus, TaskSpec  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    ContinuousEngine,
    Engine,
    Request,
    SamplingParams,
    make_engine,
)
from repro_torch.training import trainer  # noqa: E402

torch.set_num_threads(2)

JCFG = jax_get_config("qwen2-0.5b").reduced(dtype="float32")
CFG = get_config("qwen2-0.5b").reduced(dtype="float32")
P, G, B = 8, 16, 4
T = P + G
TIGHT = T // B + 2          # too small for two full canvases: preempts
TAU = 0.5
EMBED_SCALE = 40.0          # sharpens the tied head: iterations finalize >1
CONF_RTOL = 1e-6


@pytest.fixture(scope="module")
def tree():
    t = jax.tree_util.tree_map(np.asarray,
                               init_model(jax.random.PRNGKey(0), JCFG))
    t["embed"]["tok"] = t["embed"]["tok"] * EMBED_SCALE
    t["embed"]["tok"][CFG.mask_token_id] = 0.0
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


def _same_result(got, want):
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.steps.numpy(), np.asarray(want.steps))
    assert got.n_model_calls == int(want.n_model_calls)
    np.testing.assert_array_equal(got.gen_lengths.numpy(),
                                  np.asarray(want.gen_lengths))


# ---------------------------------------------------------------------------
# candidate selection
# ---------------------------------------------------------------------------
def test_sampled_candidates_match_jax():
    rng = np.random.default_rng(1)
    logits = rng.normal(0, 2, (3, 5, CFG.vocab_size)).astype(np.float32)
    tokens = np.where(rng.random((3, 5)) < 0.6, CFG.mask_token_id, 4)
    k = jax.random.PRNGKey(2)
    want = jax_d.confidence_and_candidates(
        jnp.asarray(logits), jnp.asarray(tokens), CFG.mask_token_id, 0.7, k)
    got = D.confidence_and_candidates(
        torch.as_tensor(logits), torch.as_tensor(tokens), CFG.mask_token_id,
        0.7, _key(k))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=CONF_RTOL)
    # the draw is not the argmax everywhere
    assert (got[0].numpy() != logits.argmax(-1)).any()


def test_per_lane_candidates_match_jax():
    rng = np.random.default_rng(2)
    logits = rng.normal(0, 2, (4, 5, CFG.vocab_size)).astype(np.float32)
    tokens = np.full((4, 5), CFG.mask_token_id)
    temps = np.array([0.0, 0.7, 1.3, 0.0], np.float32)
    keys = jax.random.split(jax.random.PRNGKey(3), 4)
    for with_keys in (True, False):
        want = jax_d.confidence_and_candidates_per_lane(
            jnp.asarray(logits), jnp.asarray(tokens), CFG.mask_token_id,
            jnp.asarray(temps), keys if with_keys else None)
        got = D.confidence_and_candidates_per_lane(
            torch.as_tensor(logits), torch.as_tensor(tokens),
            CFG.mask_token_id, torch.as_tensor(temps),
            _key(keys) if with_keys else None)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   rtol=CONF_RTOL)


# ---------------------------------------------------------------------------
# run_block_loop
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("temperature,fused", [(0.0, False), (0.0, True),
                                               (0.7, False), (0.7, True)],
                         ids=["greedy", "greedy-fused", "sampled",
                              "sampled-fused-spec"])
def test_cdlm_block_loop_matches_jax(jparams, params, layout, temperature,
                                     fused):
    prompts = _prompts(3)
    kw = dict(prompt_len=P, gen_len=G, block_size=B, conf_threshold=TAU,
              temperature=temperature, cache_layout=layout,
              fused_select=fused)
    want = JB.run_block_loop(jparams, jnp.asarray(prompts), cfg=JCFG,
                             spec=JB.SamplerSpec(**kw),
                             strategy=JB.STRATEGIES["cdlm"],
                             key=jax.random.PRNGKey(3))
    got = SAMPLERS["cdlm"](params, torch.as_tensor(prompts), cfg=CFG,
                           spec=TB.SamplerSpec(**kw), key=prng.key(3))
    _same_result(got, want)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_cdlm_per_lane_mixed_matches_jax(jparams, params, layout):
    prompts = _prompts(4, seed=1)
    temps = np.array([0.0, 0.7, 1.1, 0.4], np.float32)
    taus = np.array([TAU, 0.3, 0.9, TAU], np.float32)
    eos = np.array([CFG.eos_token_id, 7, CFG.eos_token_id, 9])
    keys = np.stack([np.asarray(jax.random.PRNGKey(s)) for s in (5, 6, 7, 8)])
    jl = JB.LaneParams(temperature=jnp.asarray(temps),
                       conf_threshold=jnp.asarray(taus),
                       eos_id=jnp.asarray(eos, jnp.int32),
                       key=jnp.asarray(keys))
    tl = TB.LaneParams(temperature=torch.as_tensor(temps),
                       conf_threshold=torch.as_tensor(taus),
                       eos_id=torch.as_tensor(eos),
                       key=torch.as_tensor(keys.astype(np.int64)))
    kw = dict(prompt_len=P, gen_len=G, block_size=B, conf_threshold=TAU,
              cache_layout=layout)
    want = JB.run_block_loop(jparams, jnp.asarray(prompts), cfg=JCFG,
                             spec=JB.SamplerSpec(**kw),
                             strategy=JB.STRATEGIES["cdlm"], lane_params=jl,
                             lane_sampled=True)
    got = TB.run_block_loop(params, torch.as_tensor(prompts), cfg=CFG,
                            spec=TB.SamplerSpec(**kw),
                            strategy=TB.STRATEGIES["cdlm"], lane_params=tl,
                            lane_sampled=True)
    _same_result(got, want)


@pytest.mark.parametrize("name", ["fast_dllm", "dual_cache",
                                  "interval_cache", "ar"])
def test_unported_strategies_are_refused(params, name):
    """The six decoders are ported, so what stays refused is a (cache
    policy, finalize rule) pair that none of them declares: here the
    decoder's policy under another decoder's rule. The decoder itself is
    served."""
    assert sorted(SAMPLERS) == sorted(TB.STRATEGIES)
    spec = TB.SamplerSpec(prompt_len=P, gen_len=G, block_size=B)
    declared = TB.STRATEGIES[name]
    rule = "top1" if declared.finalize != "top1" else "threshold"
    if (declared.cache_policy, rule) in TB.PORTED:
        rule = "greedy-next"
    odd = TB.DecodeStrategy(f"{name}-{rule}", declared.attn_mode,
                            declared.cache_policy, rule)
    with pytest.raises(ValueError, match="none of the six decoders"):
        TB.run_block_loop(params, torch.as_tensor(_prompts(1)), cfg=CFG,
                          spec=spec, strategy=odd)
    eng = Engine(params, CFG, _serve(ServeConfig, sampler=name), prompt_len=P,
                 device="cpu")
    assert (eng.spec.cache_refresh_interval
            == ServeConfig().cache_refresh_interval)


# ---------------------------------------------------------------------------
# the static engine
# ---------------------------------------------------------------------------
def _serve(cls, **kw):
    base = dict(max_batch=2, block_size=B, gen_length=G, conf_threshold=TAU)
    return cls(**dict(base, **kw))


def _mixed_trace(cls, sp_cls, n=5):
    """Greedy, sampled and bare requests with mixed caps, one per-request
    threshold and one EOS override."""
    prompts = _prompts(n, seed=4)
    params = [None, sp_cls(temperature=0.7, seed=11),
              sp_cls(conf_threshold=0.3), sp_cls(temperature=1.2, seed=5,
                                                 eos_token_id=7),
              sp_cls(temperature=0.9)][:n]
    caps = [None, 2 * B, None, None, 3 * B][:n]
    return [cls(prompt=p, id=i, max_tokens=c, params=sp)
            for i, (p, c, sp) in enumerate(zip(prompts, caps, params))]


def _bare_trace(cls, sp_cls, n=3):
    del sp_cls
    return [cls(prompt=p, id=i) for i, p in enumerate(_prompts(n, seed=5))]


def _same_outputs(got, want):
    got = {o.id: o for o in got}
    want = {o.id: o for o in want}
    assert sorted(got) == sorted(want)
    for rid, w in want.items():
        g = got[rid]
        np.testing.assert_array_equal(g.tokens, np.asarray(w.tokens), rid)
        assert (g.steps, g.gen_length, g.finish_reason) == \
            (w.steps, w.gen_length, w.finish_reason), rid


@pytest.mark.parametrize("case", ["greedy-fused", "sampled-default",
                                  "per-request-mixed"])
def test_static_engine_matches_jax(jparams, params, case):
    kw = {"greedy-fused": dict(fused_select=True),
          "sampled-default": dict(temperature=0.7),
          "per-request-mixed": {}}[case]
    trace = _mixed_trace if case == "per-request-mixed" else _bare_trace
    jeng = JaxEngine(jparams, JCFG, _serve(JaxServeConfig, **kw),
                     prompt_len=P)
    eng = Engine(params, CFG, _serve(ServeConfig, **kw), prompt_len=P,
                 device="cpu")
    key = jax.random.PRNGKey(21)
    want = jeng.generate(trace(JaxRequest, JaxSP), key=key)
    got = eng.generate(trace(Request, SamplingParams), key=_key(key))
    _same_outputs(got, want)


def test_static_engine_streams_its_batches(params):
    eng = make_engine(params, CFG, _serve(ServeConfig, scheduler="static"),
                      P, device="cpu")
    assert isinstance(eng, Engine)
    reqs = _mixed_trace(Request, SamplingParams)
    final = {o.id: o for o in eng.generate(reqs)}
    blocks = {}
    for ev in eng.stream(_mixed_trace(Request, SamplingParams)):
        blocks.setdefault(ev.request_id, []).append(ev.tokens)
    for rid, out in final.items():
        span = np.concatenate(blocks[rid])
        np.testing.assert_array_equal(span[:len(out.tokens)], out.tokens)


# ---------------------------------------------------------------------------
# the continuous engine without fused select
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("layout", ["dense", "paged", "paged-tight"])
def test_continuous_engine_sampled_matches_jax(jparams, params, layout):
    kw = dict(scheduler="continuous")
    if layout != "dense":
        kw["cache_layout"] = "paged"
    if layout == "paged-tight":
        kw["page_pool_pages"] = TIGHT
    jeng = JaxContinuous(jparams, JCFG, _serve(JaxServeConfig, **kw),
                         prompt_len=P)
    eng = ContinuousEngine(params, CFG, _serve(ServeConfig, **kw),
                           prompt_len=P, device="cpu")
    want = jeng.generate(_mixed_trace(JaxRequest, JaxSP))
    got = eng.generate(_mixed_trace(Request, SamplingParams))
    _same_outputs(got, want)
    assert eng.call_counts()["total"] == int(jeng._state.calls)
    if layout == "paged-tight":
        stats = eng.page_pool_stats()
        assert stats["preemptions"] >= 1
        for k in ("preemptions", "stall_rounds", "peak_pages"):
            assert stats[k] == jeng.page_pool_stats()[k], k


def test_sampled_lane_decodes_alone_as_batched(params):
    eng = ContinuousEngine(params, CFG, _serve(ServeConfig,
                                               scheduler="continuous"),
                           prompt_len=P, device="cpu")
    reqs = _mixed_trace(Request, SamplingParams)
    batched = {o.id: o for o in eng.generate(reqs)}
    static = Engine(params, CFG, _serve(ServeConfig), prompt_len=P,
                    device="cpu")
    for r in reqs:
        if r.params is None or not (r.params.temperature or 0) > 0:
            continue
        want = batched[r.id]
        for e in (eng, static):
            solo = e.generate([Request(prompt=r.prompt, id=r.id,
                                       max_tokens=r.max_tokens,
                                       params=r.params)])[0]
            np.testing.assert_array_equal(solo.tokens, want.tokens)
            assert solo.gen_length == want.gen_length
        # the static engine decodes past a max_tokens cap and trims; the
        # continuous one stops at the cap's block: steps agree in the latter
        assert solo.steps >= want.steps
        assert eng.generate([Request(prompt=r.prompt, id=r.id,
                                     max_tokens=r.max_tokens,
                                     params=r.params)])[0].steps == want.steps


def test_the_seed_sets_the_stream(params):
    eng = ContinuousEngine(params, CFG, _serve(ServeConfig,
                                               scheduler="continuous"),
                           prompt_len=P, device="cpu")
    prompt = _prompts(1, seed=6)[0]

    def run(seed, rid=0):
        return eng.generate([Request(prompt=prompt, id=rid, params=(
            SamplingParams(temperature=1.5, seed=seed)))])[0].tokens

    np.testing.assert_array_equal(run(3), run(3, rid=9))
    draws = {tuple(run(s)) for s in range(4)}
    assert len(draws) > 1
    # an unset seed is the request id
    unset = eng.generate([Request(prompt=prompt, id=2, params=SamplingParams(
        temperature=1.5))])[0].tokens
    np.testing.assert_array_equal(unset, run(2))


# ---------------------------------------------------------------------------
# collection at the augmentation temperatures
# ---------------------------------------------------------------------------
def test_collect_dataset_threads_the_reference_key(tree):
    """``trainer.collect_dataset`` (PRNGKey(seed), split once per batch,
    each batch's key split once per temperature) equals the JAX trainer's
    on the same corpus: tokens and step indices exactly, hidden within
    1e-4."""
    cdlm_kw = dict(block_size=B, gen_length=G, prompt_length=P,
                   temperatures=(0.0, 0.5))
    task = dict(vocab_size=CFG.vocab_size, prompt_len=P, gen_len=G,
                sort_k=4, sort_range=24)
    want = jax_trainer.collect_dataset(
        jax.tree_util.tree_map(jnp.asarray, tree), JCFG, JaxCDLM(**cdlm_kw),
        JaxCorpus(JaxTask("sort", **task), 16, seed=0), n_examples=4,
        batch=2, seed=3, verbose=False)
    got = trainer.collect_dataset(
        params_from_jax(tree, CFG, "cpu"), CFG, CDLMConfig(**cdlm_kw),
        Corpus(TaskSpec("sort", **task), 16, seed=0), n_examples=4, batch=2,
        seed=3, verbose=False)
    for k in ("prompt", "gt", "final", "finalized_at"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    np.testing.assert_allclose(got["hidden"].numpy(),
                               np.asarray(want["hidden"]), atol=1e-4)
    assert dataclasses.asdict(CDLMConfig())["temperatures"] == (0.0, 0.5)
