"""rwkv6 (attention-free: RWKV time and channel mix, layernorm, no
positions) decoded by the paper's six decoders, the port against the JAX
package on the CPU, from the same numpy params and prompts at
``ModelConfig.reduced()`` fp32 (``tests/_torch_recurrent.py``): through
``run_block_loop`` (greedy through the fused select; ``cdlm`` sampled at
0.7), the static ``Engine`` (five requests of mixed ``max_tokens``
through two lanes) and the ``ContinuousEngine`` (``cdlm``, greedy and with
two sampled requests), on the dense layout, the only one an
attention-free cache has: both engines refuse the paged layout with the
reference's error. ``ar`` is the reference's decode for this backbone
(its state committed at every token). Tokens, steps, calls, generation
lengths and finish reasons exactly; and a request admitted into a
recycled lane decodes as it does alone."""
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
    Engine,
    Request,
    SamplingParams,
)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def rwkv():
    return RC.setup("rwkv6-1.6b")


@pytest.mark.parametrize("name", RC.DECODERS)
def test_decoder_matches_jax(rwkv, name):
    RC.check_decoder(rwkv, name)


def test_sampled_cdlm_matches_jax(rwkv):
    RC.check_sampled_cdlm(rwkv)


@pytest.mark.parametrize("name", RC.DECODERS)
def test_static_engine_matches_jax(rwkv, name):
    RC.check_static_engine(rwkv, name)


@pytest.mark.parametrize("sampled", [(), (1, 3)], ids=["greedy", "sampled"])
def test_continuous_engine_matches_jax(rwkv, sampled):
    kw = dict(sampler="cdlm", scheduler="continuous",
              fused_select=not sampled)
    jeng = JaxContinuous(rwkv.jparams, rwkv.jcfg,
                         RC.serve(JaxServeConfig, **kw), prompt_len=RC.P)
    want = jeng.generate(RC.trace(rwkv.cfg, JaxRequest, JaxSP,
                                  sampled=sampled))
    eng = ContinuousEngine(rwkv.params, rwkv.cfg, RC.serve(ServeConfig, **kw),
                           prompt_len=RC.P, device="cpu")
    RC.same_outputs(eng.generate(RC.trace(rwkv.cfg, Request, SamplingParams,
                                          sampled=sampled)), want)
    assert eng.call_counts()["total"] == int(jeng._state.calls)


def test_mid_flight_eviction_is_exact(rwkv):
    eng = ContinuousEngine(rwkv.params, rwkv.cfg,
                           RC.serve(ServeConfig, sampler="cdlm",
                                    scheduler="continuous",
                                    fused_select=True),
                           prompt_len=RC.P, device="cpu")
    reqs = RC.trace(rwkv.cfg, Request)
    batched = {o.id: o for o in eng.generate(reqs)}
    for req in reqs:
        solo = eng.generate([Request(prompt=req.prompt, id=req.id,
                                     max_tokens=req.max_tokens)])[0]
        got = batched[req.id]
        np.testing.assert_array_equal(solo.tokens, got.tokens, req.id)
        assert (solo.steps, solo.gen_length) == (got.steps, got.gen_length)


def test_paged_layout_is_refused_as_in_the_reference(rwkv):
    msg = "paged layout needs attention KV"
    kw = dict(sampler="cdlm", cache_layout="paged")
    with pytest.raises(ValueError, match=msg):
        JaxContinuous(rwkv.jparams, rwkv.jcfg,
                      RC.serve(JaxServeConfig, scheduler="continuous", **kw),
                      prompt_len=RC.P)
    with pytest.raises(ValueError, match=msg):
        ContinuousEngine(rwkv.params, rwkv.cfg,
                         RC.serve(ServeConfig, scheduler="continuous", **kw),
                         prompt_len=RC.P, device="cpu")
    with pytest.raises(ValueError, match=msg):
        Engine(rwkv.params, rwkv.cfg, RC.serve(ServeConfig, **kw),
               prompt_len=RC.P, device="cpu").generate(
                   RC.trace(rwkv.cfg, Request, n=1))
