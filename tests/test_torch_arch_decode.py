"""Greedy CDLM decode of the Gemma pair and the MoE configs, the port
against the JAX package, on the CPU, from the same numpy params and
prompts, at ``ModelConfig.reduced()`` in fp32 (temperature 0, fused
select): through ``run_block_loop``, the static ``Engine`` and the
``ContinuousEngine``, on the dense and the paged cache; gemma2 with a
sliding window shorter than the canvas, so its local slots mask in the
prefill and in every cached forward; and kimi-k2 with 48 experts, top 1,
where the cached forwards' bounded capacity drops tokens (the reduced
configs' 4 experts never do): the reference's block loop shares each
expert's capacity among the batch's lanes, its continuous engine gives
each lane its own (a one-lane forward vmapped over lanes), and the port
must do each. The unembedding is scaled up, so
some iterations finalize more than one token, and the mask token's row
zeroed, as in a trained model.

Token equality is the criterion: tokens, per-lane steps and the number of
model calls exactly, and the paged layout's equal to the dense one's. A
differing token is a fault of the port, never a tolerance."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ServeConfig as JaxServeConfig  # noqa: E402
from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.core import block_loop as JB  # noqa: E402
from repro.core.sampler import SAMPLERS as JAX_SAMPLERS  # noqa: E402
from repro.models import init_model  # noqa: E402
from repro.serving import ContinuousEngine as JaxContinuous  # noqa: E402
from repro.serving import Engine as JaxEngine  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import ServeConfig, get_config  # noqa: E402
from repro_torch.core import block_loop as TB  # noqa: E402
from repro_torch.core.sampler import SAMPLERS  # noqa: E402
from repro_torch.serving import ContinuousEngine, Engine, Request  # noqa: E402

torch.set_num_threads(2)

P, G, B = 8, 16, 4
TAU = 0.5
HEAD_SCALE = 40.0    # sharpens the head: some iterations finalize > 1
DROPS = ("kimi-k2-1t-a32b", {"n_experts": 48, "experts_per_token": 1})
CASES = [("gemma-7b", {}), ("gemma2-27b", {}),
         ("llama4-maverick-400b-a17b", {}), ("kimi-k2-1t-a32b", {}),
         ("gemma2-27b", {"sliding_window": 6}), DROPS]
IDS = [n + "".join(f"-{k}{v}" for k, v in kw.items()) for n, kw in CASES]


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def case(request):
    name, kw = request.param
    jcfg = dataclasses.replace(
        jax_get_config(name).reduced(dtype="float32"), **kw)
    cfg = dataclasses.replace(get_config(name).reduced(dtype="float32"),
                              **kw)
    tree = jax.tree_util.tree_map(np.asarray,
                                  init_model(jax.random.PRNGKey(0), jcfg))
    if cfg.tie_embeddings:
        tree["embed"]["tok"] = tree["embed"]["tok"] * HEAD_SCALE
        tree["embed"]["tok"][cfg.mask_token_id] = 0.0
    else:                                   # the JAX head is (d, V)
        tree["embed"]["head"] = tree["embed"]["head"] * HEAD_SCALE
        tree["embed"]["head"][:, cfg.mask_token_id] = 0.0
    return dict(jcfg=jcfg, cfg=cfg, drops=(name, kw) == DROPS,
                jparams=jax.tree_util.tree_map(jnp.asarray, tree),
                params=params_from_jax(tree, cfg, "cpu"))


def _prompts(cfg, n, seed=0):
    return np.random.default_rng(seed).integers(2, cfg.vocab_size - 1,
                                                (n, P), dtype=np.int32)


def _spec_kw(**kw):
    return dict(dict(prompt_len=P, gen_len=G, block_size=B,
                     conf_threshold=TAU, fused_select=True), **kw)


def test_run_block_loop_matches_jax(case):
    """Six lanes: at the drop case's capacity the batch's mask tokens
    overflow an expert in some of the cached forwards."""
    cfg = case["cfg"]
    prompts = _prompts(cfg, 6)
    want = JAX_SAMPLERS["cdlm"](case["jparams"], jnp.asarray(prompts),
                                cfg=case["jcfg"],
                                spec=JB.SamplerSpec(**_spec_kw()))
    for layout in ("dense", "paged"):
        got = SAMPLERS["cdlm"](case["params"], torch.as_tensor(prompts),
                               cfg=cfg, spec=TB.SamplerSpec(
                                   **_spec_kw(cache_layout=layout)))
        np.testing.assert_array_equal(got.tokens.numpy(),
                                      np.asarray(want.tokens), layout)
        np.testing.assert_array_equal(got.steps.numpy(),
                                      np.asarray(want.steps), layout)
        assert got.n_model_calls == int(want.n_model_calls), layout
    # some iteration finalized more than one token
    assert (got.steps.numpy() < G).any()


def _serve(cls, **kw):
    base = dict(max_batch=2, block_size=B, gen_length=G, conf_threshold=TAU,
                fused_select=True, sampler="cdlm")
    return cls(**dict(base, **kw))


def _trace(cls, cfg, n=5):
    caps = [None, 2 * B, None, B, 3 * B][:n]
    return [cls(prompt=p, id=i, max_tokens=c)
            for i, (p, c) in enumerate(zip(_prompts(cfg, n, seed=4), caps))]


def _same_outputs(got, want):
    got, want = {o.id: o for o in got}, {o.id: o for o in want}
    assert sorted(got) == sorted(want)
    for rid, w in want.items():
        g = got[rid]
        np.testing.assert_array_equal(g.tokens, np.asarray(w.tokens), rid)
        assert (g.steps, g.gen_length, g.finish_reason) == \
            (w.steps, w.gen_length, w.finish_reason), rid


def test_static_engine_matches_jax(case):
    cfg = case["cfg"]
    jeng = JaxEngine(case["jparams"], case["jcfg"], _serve(JaxServeConfig),
                     prompt_len=P)
    want = jeng.generate(_trace(JaxRequest, cfg))
    for layout in ("dense", "paged"):
        eng = Engine(case["params"], cfg,
                     _serve(ServeConfig, cache_layout=layout), prompt_len=P,
                     device="cpu")
        _same_outputs(eng.generate(_trace(Request, cfg)), want)


def test_continuous_engine_matches_jax(case):
    """Five requests through two lanes (lanes evicted and refilled mid
    flight): the MoE slots' capacity prefill runs every lane, as the
    reference's does, and the cached forwards are dropless."""
    cfg = case["cfg"]
    jeng = JaxContinuous(case["jparams"], case["jcfg"],
                         _serve(JaxServeConfig, scheduler="continuous"),
                         prompt_len=P)
    want = jeng.generate(_trace(JaxRequest, cfg))
    calls = int(jeng._state.calls)
    for layout in ("dense", "paged"):
        eng = ContinuousEngine(
            case["params"], cfg,
            _serve(ServeConfig, scheduler="continuous", cache_layout=layout),
            prompt_len=P, device="cpu")
        _same_outputs(eng.generate(_trace(Request, cfg)), want)
        assert eng.call_counts()["total"] == calls, layout


def test_capacity_drops_happen_where_meant(case, monkeypatch):
    """The drop case exercises what it is meant to: the static loop's
    batched cached forwards drop tokens (more of the batch's tokens choose
    one expert than its capacity), and in the continuous engine's cached
    forwards the whole batch would overflow one shared capacity, so giving
    each lane its own is what keeps the port's tokens the reference's. The
    other cases never overflow (and a config without an MOE slot never
    reaches the MoE FFN)."""
    from repro_torch.models import moe as MO
    cfg, seen = case["cfg"], []
    real = MO.apply_moe

    def over(p, x, c, T):
        cap = MO.dropless_capacity(T, c)
        _, _, ids = MO.route(p, x.reshape(-1, x.shape[-1]), c)
        rows = ids.view(-1, T, c.experts_per_token)
        return any(int(torch.bincount(r[:, j], minlength=c.n_experts).max())
                   > cap for r in rows for j in range(c.experts_per_token))

    def spy(p, x, c, dropless=False, *, moe_per_row):
        if dropless:
            b, L = x.shape[:2]
            seen.append((moe_per_row, over(p, x, c, b * L)))
        return real(p, x, c, dropless=dropless, moe_per_row=moe_per_row)

    monkeypatch.setattr(MO, "apply_moe", spy)
    ContinuousEngine(case["params"], cfg,
                     _serve(ServeConfig, scheduler="continuous"),
                     prompt_len=P, device="cpu").generate(_trace(Request, cfg))
    lane = [o for per_row, o in seen if per_row]
    SAMPLERS["cdlm"](case["params"], torch.as_tensor(_prompts(cfg, 6)),
                     cfg=cfg, spec=TB.SamplerSpec(**_spec_kw()))
    batch = [o for per_row, o in seen if not per_row]
    if not cfg.n_experts:
        assert not seen
        return
    assert lane and batch       # both groupings ran
    assert any(lane) == any(batch) == case["drops"]
