"""``long_context_window`` serving: internvl2-1b at ``reduced()`` fp32
(window 128) with 120-token prompts, so that every block's absolute
position (after the 8 prefix rows in the static engine) lies past the
window, through both of the port's engines against the JAX engines with
``use_long_window=True``. Tokens, steps, generation lengths and finish
reasons exactly, and different from the same engines' tokens without the
window (so the window binds). The static engine passes the window as the
reference's two runners do: its scalar path for ``cdlm`` only, its
per-lane path for every threshold sampler (here ``dual_cache``, whose
scalar path runs without it). The continuous engine serves the same
prompts without the prefix (it refuses extras, as the reference's
does)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_extras import INTERNVL, extras, rows, setup  # noqa: E402
from _torch_recurrent import B, TAU, same_outputs  # noqa: E402
from repro.configs.base import ServeConfig as JaxServeConfig  # noqa: E402
from repro.serving import ContinuousEngine as JaxContinuous  # noqa: E402
from repro.serving import Engine as JaxEngine  # noqa: E402
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

P, G = 120, 16


@pytest.fixture(scope="module")
def s():
    return setup(INTERNVL)


def _requests(cfg, req_cls, sp_cls, *, with_extras, per_lane):
    prompts = np.random.default_rng(6).integers(2, cfg.vocab_size - 1,
                                                (3, P))
    ex = extras(cfg, 3, seed=6)
    out = []
    for i, p in enumerate(prompts):
        params = sp_cls(conf_threshold=TAU) if per_lane else None
        out.append(req_cls(prompt=p, id=i, params=params,
                           extras=rows(ex, i) if with_extras else None))
    return out


def _serve(cls, **kw):
    return cls(**dict(dict(max_batch=2, block_size=B, gen_length=G,
                           conf_threshold=TAU, fused_select=True), **kw))


def _tokens(outs):
    return {o.id: np.asarray(o.tokens).tolist() for o in outs}


@pytest.mark.parametrize("sampler, per_lane", [("cdlm", False),
                                               ("dual_cache", False),
                                               ("dual_cache", True)])
def test_static_engine(s, sampler, per_lane):
    off = s.cfg.n_prefix_embeds
    assert P + off >= s.cfg.long_context_window
    runs = {}
    for window in (True, False):
        jeng = JaxEngine(s.jparams, s.jcfg, _serve(JaxServeConfig,
                                                    sampler=sampler),
                         prompt_len=P, pos_offset=off,
                         use_long_window=window)
        want = jeng.generate(_requests(s.cfg, JaxRequest, JaxSP,
                                       with_extras=True, per_lane=per_lane))
        eng = Engine(s.params, s.cfg, _serve(ServeConfig, sampler=sampler),
                     prompt_len=P, pos_offset=off, use_long_window=window,
                     device="cpu")
        got = eng.generate(_requests(s.cfg, Request, SamplingParams,
                                     with_extras=True, per_lane=per_lane))
        same_outputs(got, want)
        runs[window] = _tokens(got)
    # the scalar dual_cache runner takes no window (the reference's quirk)
    binds = sampler == "cdlm" or per_lane
    assert (runs[True] != runs[False]) == binds


def test_continuous_engine(s):
    runs = {}
    for window in (True, False):
        jeng = JaxContinuous(s.jparams, s.jcfg,
                             _serve(JaxServeConfig, scheduler="continuous"),
                             prompt_len=P, use_long_window=window)
        want = jeng.generate(_requests(s.cfg, JaxRequest, JaxSP,
                                       with_extras=False, per_lane=False))
        eng = ContinuousEngine(s.params, s.cfg,
                               _serve(ServeConfig, scheduler="continuous"),
                               prompt_len=P, use_long_window=window,
                               device="cpu")
        got = eng.generate(_requests(s.cfg, Request, SamplingParams,
                                     with_extras=False, per_lane=False))
        same_outputs(got, want)
        runs[window] = _tokens(got)
    assert runs[True] != runs[False]
