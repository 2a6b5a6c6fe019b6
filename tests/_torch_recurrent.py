"""Shared set-up of the recurrent-state configs' decode tests
(``test_torch_jamba_*.py``, ``test_torch_rwkv_decode.py``): the JAX and
port configs at ``reduced()`` fp32, one numpy param tree handed to both,
prompts, traces, and the comparisons. The untied head is scaled up (so
some iterations finalize more than one token) and its mask-token column
zeroed, as in a trained model.

Token equality is the criterion: tokens, per-lane steps, the number of
model calls and generation lengths exactly. A differing token is a fault
of the port, never a tolerance."""
import dataclasses

import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro.configs.registry import get_config as jax_get_config
from repro.models import init_model
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config

P, G, B, R = 8, 8, 4, 2
TAU = 0.5
HEAD_SCALE = 40.0
DECODERS = ("vanilla", "fast_dllm", "dual_cache", "interval_cache", "cdlm",
            "ar")


@dataclasses.dataclass
class Setup:
    jcfg: object
    cfg: object
    jparams: dict
    params: dict


def setup(name: str) -> Setup:
    jcfg = jax_get_config(name).reduced(dtype="float32")
    cfg = get_config(name).reduced(dtype="float32")
    tree = jax.tree_util.tree_map(np.asarray,
                                  init_model(jax.random.PRNGKey(0), jcfg))
    tree["embed"]["head"] = tree["embed"]["head"] * HEAD_SCALE   # (d, V)
    tree["embed"]["head"][:, cfg.mask_token_id] = 0.0
    return Setup(jcfg, cfg, jax.tree_util.tree_map(jnp.asarray, tree),
                 params_from_jax(tree, cfg, "cpu"))


def prompts(cfg, n: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(2, cfg.vocab_size - 1,
                                                (n, P), dtype=np.int32)


def spec_kw(**kw) -> dict:
    return dict(dict(prompt_len=P, gen_len=G, block_size=B,
                     conf_threshold=TAU, cache_refresh_interval=R), **kw)


def key_of(jkey) -> torch.Tensor:
    return torch.as_tensor(np.asarray(jkey).astype(np.int64))


def same_result(got, want, what=""):
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens),
                                  what)
    np.testing.assert_array_equal(got.steps.numpy(), np.asarray(want.steps),
                                  what)
    assert got.n_model_calls == int(want.n_model_calls), what
    np.testing.assert_array_equal(got.gen_lengths.numpy(),
                                  np.asarray(want.gen_lengths), what)


def serve(cls, **kw):
    base = dict(max_batch=2, block_size=B, gen_length=G, conf_threshold=TAU,
                cache_refresh_interval=R)
    return cls(**dict(base, **kw))


def trace(cfg, req_cls, sp_cls=None, n: int = 5, sampled=(), caps=None):
    """``n`` requests of mixed ``max_tokens`` (or ``caps``); the ids in
    ``sampled`` at temperature 0.7 with their own seed."""
    caps = caps or [None, B, None, B, None][:n]
    out = []
    for i, (p, c) in enumerate(zip(prompts(cfg, n, seed=4), caps)):
        params = (sp_cls(temperature=0.7, seed=10 + i) if i in sampled
                  else None)
        out.append(req_cls(prompt=p, id=i, max_tokens=c, params=params))
    return out


def same_outputs(got, want):
    got, want = {o.id: o for o in got}, {o.id: o for o in want}
    assert sorted(got) == sorted(want)
    for rid, w in want.items():
        g = got[rid]
        np.testing.assert_array_equal(g.tokens, np.asarray(w.tokens), rid)
        assert (g.steps, g.gen_length, g.finish_reason) == \
            (w.steps, w.gen_length, w.finish_reason), rid


def check_decoder(s: Setup, name: str, layouts=("dense",)) -> None:
    """``name`` greedy through the fused select, the port's
    ``run_block_loop`` on each cache layout against the JAX sampler: two
    lanes of ``prompts``."""
    from repro.core import block_loop as JB
    from repro.core.sampler import SAMPLERS as JAX_SAMPLERS
    from repro_torch.core import block_loop as TB
    from repro_torch.core.sampler import SAMPLERS
    p = prompts(s.cfg, 2)
    kw = spec_kw(fused_select=True)
    want = JAX_SAMPLERS[name](s.jparams, jnp.asarray(p), cfg=s.jcfg,
                              spec=JB.SamplerSpec(**kw))
    for layout in layouts:
        got = SAMPLERS[name](s.params, torch.as_tensor(p), cfg=s.cfg,
                             spec=TB.SamplerSpec(**kw, cache_layout=layout))
        same_result(got, want, f"{name} {layout}")
    if name not in ("vanilla", "ar"):
        # the case decodes what it is meant to: some iteration finalized
        # more than one token
        assert (got.steps.numpy() < G).any(), name


def _batch_calls(s: Setup, name: str, layout: str) -> int:
    """The calls of the static engine's batches of ``trace`` through
    ``run_block_loop``: two lanes each, the last batch padded with its
    last prompt."""
    from repro_torch.core import block_loop as TB
    from repro_torch.core.sampler import SAMPLERS
    from repro_torch.serving import Request
    reqs = trace(s.cfg, Request)
    total = 0
    for i in range(0, len(reqs), 2):
        chunk = [r.prompt for r in reqs[i:i + 2]]
        chunk += [chunk[-1]] * (2 - len(chunk))
        total += SAMPLERS[name](
            s.params, torch.as_tensor(np.stack(chunk)), cfg=s.cfg,
            spec=TB.SamplerSpec(**spec_kw(fused_select=True,
                                          cache_layout=layout))
        ).n_model_calls
    return total


def check_static_engine(s: Setup, name: str, layouts=("dense",)) -> None:
    """``name`` through the static ``Engine`` (``trace``: five requests,
    two lanes, three batches) on each cache layout against the JAX
    engine's outputs; the port's call count is its batches'
    ``run_block_loop`` calls."""
    from repro.configs.base import ServeConfig as JaxServeConfig
    from repro.serving import Engine as JaxEngine
    from repro.serving import Request as JaxRequest
    from repro_torch.configs import ServeConfig
    from repro_torch.serving import Engine, Request
    jeng = JaxEngine(s.jparams, s.jcfg,
                     serve(JaxServeConfig, sampler=name, fused_select=True),
                     prompt_len=P)
    want = jeng.generate(trace(s.cfg, JaxRequest))
    for layout in layouts:
        eng = Engine(s.params, s.cfg,
                     serve(ServeConfig, sampler=name, fused_select=True,
                           cache_layout=layout),
                     prompt_len=P, device="cpu")
        same_outputs(eng.generate(trace(s.cfg, Request)), want)
        assert eng.call_counts() == {
            "batches": 3, "total": _batch_calls(s, name, layout)}


def check_sampled_cdlm(s: Setup) -> None:
    """``cdlm`` sampled at 0.7 from ``PRNGKey(3)`` through
    ``run_block_loop`` against the JAX sampler (the reference's threefry
    stream, the draw shaped like its canvas logits)."""
    from repro.core import block_loop as JB
    from repro.core.sampler import SAMPLERS as JAX_SAMPLERS
    from repro_torch import prng
    from repro_torch.core import block_loop as TB
    from repro_torch.core.sampler import SAMPLERS
    p = prompts(s.cfg, 2, seed=1)
    kw = spec_kw(temperature=0.7)
    want = JAX_SAMPLERS["cdlm"](s.jparams, jnp.asarray(p), cfg=s.jcfg,
                                spec=JB.SamplerSpec(**kw),
                                key=jax.random.PRNGKey(3))
    got = SAMPLERS["cdlm"](s.params, torch.as_tensor(p), cfg=s.cfg,
                           spec=TB.SamplerSpec(**kw), key=prng.key(3))
    same_result(got, want)
