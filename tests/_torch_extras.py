"""Shared set-up of the request-extras tests (``test_torch_whisper*.py``,
``test_torch_prefix*.py``, ``test_torch_extras_training.py``): whisper-base
and internvl2-1b at ``reduced()`` fp32, one numpy param tree handed to the
JAX package and the port, and seeded numpy extras (0.1 N(0, 1), fp32):
whisper's frame embeddings (encoder_seq_len, d) and internvl2's prefix
(n_prefix_embeds, d). whisper's encoder runs 3 layers against the
decoder's 2, so that a stack split by the decoder's period count would
show. The untied head is scaled up and its mask-token column zeroed, as
in ``_torch_recurrent.py``, by ``HEAD_SCALE``.

Token equality is the criterion for decodes: tokens, per-lane steps, the
number of model calls and generation lengths exactly."""
import dataclasses

import numpy as np
import torch

import jax
import jax.numpy as jnp

from _torch_recurrent import Setup
from repro.configs.registry import get_config as jax_get_config
from repro.models import init_model
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config

WHISPER = "whisper-base"
INTERNVL = "internvl2-1b"
ENCODER_LAYERS = 3          # whisper reduced: 2 decoder layers
# the decode tests' head scale: some iterations finalize several tokens at
# tau 0.5, and some blocks take more than one iteration
HEAD_SCALE = {WHISPER: 3.5, INTERNVL: 5.0}


def configs(name: str):
    """(JAX config, port config) at ``reduced()`` fp32."""
    over = ({"n_encoder_layers": ENCODER_LAYERS} if name == WHISPER
            else {})
    jcfg = dataclasses.replace(jax_get_config(name).reduced(dtype="float32"),
                               **over)
    cfg = dataclasses.replace(get_config(name).reduced(dtype="float32"),
                              **over)
    return jcfg, cfg


def setup(name: str, head_scale: float = None) -> Setup:
    jcfg, cfg = configs(name)
    if head_scale is None:
        head_scale = HEAD_SCALE[name]
    tree = jax.tree_util.tree_map(np.asarray,
                                  init_model(jax.random.PRNGKey(0), jcfg))
    tree["embed"]["head"] = tree["embed"]["head"] * head_scale   # (d, V)
    tree["embed"]["head"][:, cfg.mask_token_id] = 0.0
    return Setup(jcfg, cfg, jax.tree_util.tree_map(jnp.asarray, tree),
                 params_from_jax(tree, cfg, "cpu"))


def extras(cfg, n: int, seed: int = 0) -> dict:
    """The request extras of ``n`` lanes as numpy fp32 arrays."""
    rng = np.random.default_rng(100 + seed)
    out = {}
    if cfg.is_encoder_decoder:
        out["encoder_embeds"] = 0.1 * rng.standard_normal(
            (n, cfg.encoder_seq_len, cfg.d_model))
    if cfg.n_prefix_embeds:
        out["prefix_embeds"] = 0.1 * rng.standard_normal(
            (n, cfg.n_prefix_embeds, cfg.d_model))
    return {k: v.astype(np.float32) for k, v in out.items()}


def to_jax(ex: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in ex.items()}


def to_torch(ex: dict) -> dict:
    return {k: torch.as_tensor(v) for k, v in ex.items()}


def rows(ex: dict, i: int) -> dict:
    """One request's extras: row ``i`` of each."""
    return {k: v[i] for k, v in ex.items()}


def check_decoder(s, name: str, *, layouts=("dense",), temperature=0.0,
                  n: int = 2) -> None:
    """``name`` through the port's sampler (``run_block_loop``) on each
    cache layout against the JAX sampler, ``n`` lanes of ``prompts`` with
    their extras: greedy through the fused select, or sampled at
    ``temperature`` from ``PRNGKey(3)``. Tokens, steps, calls and
    generation lengths exactly; a threshold decoder must have finalized
    more than one token in some iteration and taken more than one
    iteration in some block."""
    from _torch_recurrent import G, prompts, same_result, spec_kw
    from repro.core import block_loop as JB
    from repro.core.sampler import SAMPLERS as JAX_SAMPLERS
    from repro_torch import prng
    from repro_torch.core import block_loop as TB
    from repro_torch.core.sampler import SAMPLERS
    p, ex = prompts(s.cfg, n), extras(s.cfg, n)
    off = s.cfg.n_prefix_embeds
    kw = spec_kw(fused_select=temperature == 0, temperature=temperature,
                 pos_offset=off)
    want = JAX_SAMPLERS[name](s.jparams, jnp.asarray(p), cfg=s.jcfg,
                              spec=JB.SamplerSpec(**kw),
                              key=jax.random.PRNGKey(3), extras=to_jax(ex))
    for layout in layouts:
        got = SAMPLERS[name](s.params, torch.as_tensor(p), cfg=s.cfg,
                             spec=TB.SamplerSpec(**kw, cache_layout=layout),
                             key=prng.key(3), extras=to_torch(ex))
        same_result(got, want, f"{name} {layout}")
    if name not in ("vanilla", "ar"):
        steps = got.steps.numpy()
        assert (steps < G).any() and (steps > G // 4).any(), (name, steps)


def requests(cfg, req_cls, sp_cls=None, n: int = 5, sampled=()):
    """``_torch_recurrent.trace``'s ``n`` requests of mixed ``max_tokens``,
    each with its row of ``extras(cfg, n, seed=4)``."""
    from _torch_recurrent import trace
    ex = extras(cfg, n, seed=4)
    return [dataclasses.replace(r, extras=rows(ex, i)) for i, r in
            enumerate(trace(cfg, req_cls, sp_cls, n=n, sampled=sampled))]


def check_static_engine(s, name: str, *, layouts=("dense",), sampled=(),
                        use_long_window: bool = False) -> None:
    """``name`` through the port's static ``Engine`` (``requests``: five
    requests with their extras, two lanes, three batches, the last padded
    with its last request's prompt and extras) on each cache layout
    against the JAX engine's outputs; ``sampled`` requests at 0.7 with
    their own seeds move their batch to the per-lane path."""
    from _torch_recurrent import same_outputs, serve
    from repro.configs.base import ServeConfig as JaxServeConfig
    from repro.serving import Engine as JaxEngine
    from repro.serving import Request as JaxRequest
    from repro.serving import SamplingParams as JaxSP
    from repro_torch.configs import ServeConfig
    from repro_torch.serving import Engine, Request, SamplingParams
    off = s.cfg.n_prefix_embeds
    fused = not sampled
    jeng = JaxEngine(s.jparams, s.jcfg,
                     serve(JaxServeConfig, sampler=name, fused_select=fused),
                     prompt_len=8, pos_offset=off,
                     use_long_window=use_long_window)
    want = jeng.generate(requests(s.cfg, JaxRequest, JaxSP,
                                  sampled=sampled))
    for layout in layouts:
        eng = Engine(s.params, s.cfg,
                     serve(ServeConfig, sampler=name, fused_select=fused,
                           cache_layout=layout),
                     prompt_len=8, pos_offset=off,
                     use_long_window=use_long_window, device="cpu")
        same_outputs(eng.generate(requests(s.cfg, Request, SamplingParams,
                                           sampled=sampled)), want)
        assert eng.call_counts()["batches"] == 3
