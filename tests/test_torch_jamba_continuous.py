"""jamba through the ``ContinuousEngine`` (``cdlm``), the port against the
JAX package's on the CPU, from the same numpy params and requests at
``ModelConfig.reduced()`` fp32 (``tests/_torch_recurrent.py``): five
requests of mixed ``max_tokens`` through two lanes, lanes evicted and
refilled mid-flight; greedy through the fused select on the dense layout
and on a paged pool that backs every lane, on a six-page pool that
preempts (four requests of the whole grid; page statistics equal too),
and sampled (two of the
requests at 0.7, each with its own seed) on the dense layout. A lane's
Mamba state is reset at admission and replaced at each commit, only for
the lanes committed. Tokens, steps, generation lengths, finish reasons
and call counts exactly; and a request admitted into a recycled lane
decodes as it does alone, on both layouts, where no MoE token drops (see
``test_mid_flight_eviction_is_exact``)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_recurrent as RC  # noqa: E402
from repro.configs.base import ServeConfig as JaxServeConfig  # noqa: E402
from repro.serving import ContinuousEngine as JaxContinuous  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import SamplingParams as JaxSP  # noqa: E402
from repro_torch.configs import ServeConfig  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    ContinuousEngine,
    Request,
    SamplingParams,
)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jamba():
    return RC.setup("jamba-v0.1-52b")


def _serve(cls, **kw):
    return RC.serve(cls, sampler="cdlm", scheduler="continuous", **kw)


def _engine(s, **kw):
    return ContinuousEngine(s.params, s.cfg, _serve(ServeConfig, **kw),
                            prompt_len=RC.P, device="cpu")


def _jax(s, reqs, **kw):
    eng = JaxContinuous(s.jparams, s.jcfg, _serve(JaxServeConfig, **kw),
                        prompt_len=RC.P)
    return eng.generate(reqs), eng


def test_greedy_dense_and_paged_match_jax(jamba):
    want, jeng = _jax(jamba, RC.trace(jamba.cfg, JaxRequest),
                      fused_select=True)
    for layout in ("dense", "paged"):
        eng = _engine(jamba, fused_select=True, cache_layout=layout)
        RC.same_outputs(eng.generate(RC.trace(jamba.cfg, Request)), want)
        assert eng.call_counts()["total"] == int(jeng._state.calls), layout


def test_preempting_pool_matches_jax(jamba):
    """Four requests of the whole grid through a pool of six pages: two
    admitted lanes (three pages each) cannot both back their second block,
    so the younger is preempted and decoded again from its prompt."""
    kw = dict(fused_select=True, cache_layout="paged", page_pool_pages=6)
    caps = [RC.G] * 4
    want, jeng = _jax(jamba, RC.trace(jamba.cfg, JaxRequest, n=4,
                                      caps=caps), **kw)
    eng = _engine(jamba, **kw)
    RC.same_outputs(eng.generate(RC.trace(jamba.cfg, Request, n=4,
                                          caps=caps)), want)
    assert eng.call_counts()["total"] == int(jeng._state.calls)
    stats, jstats = eng.page_pool_stats(), jeng.page_pool_stats()
    assert stats["preemptions"] > 0
    for k, v in jstats.items():
        assert stats[k] == pytest.approx(float(v)), k


def test_sampled_requests_match_jax(jamba):
    want, jeng = _jax(jamba, RC.trace(jamba.cfg, JaxRequest, JaxSP,
                                      sampled=(1, 3)))
    eng = _engine(jamba)
    RC.same_outputs(eng.generate(RC.trace(jamba.cfg, Request, SamplingParams,
                                          sampled=(1, 3))), want)
    assert eng.call_counts()["total"] == int(jeng._state.calls)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_mid_flight_eviction_is_exact(jamba, layout):
    """Every request, admitted into a recycled lane beside others, decodes
    exactly as it does alone: its lane's Mamba state was reset and its
    neighbours' commits never touched it. The admission prefill is one
    capacity-dropping forward over every lane, as the reference's is, so
    at the reduced config's capacity factor (1.25) a lane's MoE slots see
    its neighbours' prompts: request 1 decodes differently alone, in the
    JAX engine as in the port. The capacity factor is raised to 4 here, so
    that no token drops and the test sees the state alone."""
    cfg = dataclasses.replace(jamba.cfg, capacity_factor=4.0)
    eng = ContinuousEngine(jamba.params, cfg,
                           _serve(ServeConfig, fused_select=True,
                                  cache_layout=layout),
                           prompt_len=RC.P, device="cpu")
    reqs = RC.trace(cfg, Request)
    batched = {o.id: o for o in eng.generate(reqs)}
    for req in reqs:
        solo = eng.generate([Request(prompt=req.prompt, id=req.id,
                                     max_tokens=req.max_tokens)])[0]
        got = batched[req.id]
        np.testing.assert_array_equal(solo.tokens, got.tokens, req.id)
        assert (solo.steps, solo.gen_length) == (got.steps, got.gen_length)
