"""The paper's six decoders (Tables 1-2), as the JAX package's
``core/sampler.py`` names them: thin
:class:`~repro_torch.core.block_loop.DecodeStrategy` declarations over
:func:`~repro_torch.core.block_loop.run_block_loop`.

====================  ===============  ================  ============
sampler               attn_mode        cache_policy      finalize
====================  ===============  ================  ============
``vanilla``           bidirectional    none              top1
``fast_dllm``         bidirectional    none              threshold
``dual_cache``        bidirectional    approx-dual       threshold
``interval_cache``    bidirectional    approx-interval   threshold
``cdlm``              block_causal     exact-commit      threshold
``ar``                causal           ar                greedy-next
====================  ===============  ================  ============

The threshold decoders decode greedy or sampled, ``vanilla`` too; ``ar``
is greedy. Each takes the request ``extras`` a config needs (whisper's
``encoder_embeds``; internvl2's ``prefix_embeds`` with
``spec.pos_offset``), as the reference's do. Every sampler returns
``SampleResult(tokens, steps, n_model_calls, gen_lengths)``: ``steps``
counts refinement iterations per sequence (the paper's "Total Steps"),
``n_model_calls`` forward passes, commit passes and counted cache
refreshes included.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.core.block_loop import (  # noqa: F401  (re-exported API)
    STRATEGIES,
    DecodeStrategy,
    SampleResult,
    SamplerSpec,
    run_block_loop,
)


def vanilla_blockwise(params, prompt_tokens, *, cfg: ModelConfig,
                      spec: SamplerSpec, key=None, extras=None,
                      record_hidden: bool = False, graphs=None):
    """Alg. 1 teacher decoding: N = G steps, one token finalized per step,
    bidirectional full recompute. With ``record_hidden`` returns
    ``(SampleResult, finalized_at, hidden)``, the trajectory collector's
    output."""
    return run_block_loop(params, prompt_tokens, cfg=cfg, spec=spec,
                          strategy=STRATEGIES["vanilla"], key=key,
                          extras=extras, record_hidden=record_hidden,
                          graphs=graphs)


def fast_dllm_parallel(params, prompt_tokens, *, cfg: ModelConfig,
                       spec: SamplerSpec, key=None, extras=None):
    """Fast-dLLM (Parallel): threshold finalization, full recompute."""
    return run_block_loop(params, prompt_tokens, cfg=cfg, spec=spec,
                          strategy=STRATEGIES["fast_dllm"], key=key,
                          extras=extras)


def dual_cache(params, prompt_tokens, *, cfg: ModelConfig,
               spec: SamplerSpec, key=None, extras=None):
    """Fast-dLLM (Par.+D.C.): stale prefix/suffix KV refreshed at block
    boundaries."""
    return run_block_loop(params, prompt_tokens, cfg=cfg, spec=spec,
                          strategy=STRATEGIES["dual_cache"], key=key,
                          extras=extras)


def interval_cache(params, prompt_tokens, *, cfg: ModelConfig,
                   spec: SamplerSpec, key=None, extras=None):
    """dLLM-Cache analog: stale KV refreshed every
    ``spec.cache_refresh_interval`` steps."""
    return run_block_loop(params, prompt_tokens, cfg=cfg, spec=spec,
                          strategy=STRATEGIES["interval_cache"], key=key,
                          extras=extras)


def cdlm(params, prompt_tokens, *, cfg: ModelConfig, spec: SamplerSpec,
         key=None, extras=None, use_long_window: bool = False):
    """The paper's student: exact block-causal KV cache, threshold parallel
    finalization, commit pass at block completion, early stop on EOS;
    ``use_long_window`` caps its cached forwards at
    ``cfg.long_context_window``."""
    return run_block_loop(params, prompt_tokens, cfg=cfg, spec=spec,
                          strategy=STRATEGIES["cdlm"], key=key, extras=extras,
                          use_long_window=use_long_window)


def ar(params, prompt_tokens, *, cfg: ModelConfig, spec: SamplerSpec,
       key=None, extras=None):
    """Autoregressive greedy decode with a KV cache (the AR baseline of
    Fig. 3); ``key`` is taken for the common signature and not read."""
    return run_block_loop(params, prompt_tokens, cfg=cfg, spec=spec,
                          strategy=STRATEGIES["ar"], key=key,
                          extras=extras)


SAMPLERS = {
    "vanilla": vanilla_blockwise,
    "fast_dllm": fast_dllm_parallel,
    "dual_cache": dual_cache,
    "interval_cache": interval_cache,
    "cdlm": cdlm,
    "ar": ar,
}
