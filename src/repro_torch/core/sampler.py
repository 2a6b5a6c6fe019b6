"""Decoders of the port, as the JAX package's ``core/sampler.py`` names
them: thin :class:`~repro_torch.core.block_loop.DecodeStrategy`
declarations over :func:`~repro_torch.core.block_loop.run_block_loop`.

Ported: ``vanilla`` (the teacher decode, also the Alg. 1 trajectory
collector) and ``cdlm`` (the student's exact-commit decode), greedy and
sampled. The other four names of the reference's table are not in
:data:`SAMPLERS`, and ``run_block_loop`` refuses their strategies (ROADMAP
Queue 1 item 9). Every sampler returns ``SampleResult(tokens, steps,
n_model_calls, gen_lengths)``.
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
                      spec: SamplerSpec, key=None,
                      record_hidden: bool = False, graphs=None):
    """Alg. 1 teacher decoding: N = G steps, one token finalized per step,
    bidirectional full recompute. With ``record_hidden`` returns
    ``(SampleResult, finalized_at, hidden)``, the trajectory collector's
    output."""
    return run_block_loop(params, prompt_tokens, cfg=cfg, spec=spec,
                          strategy=STRATEGIES["vanilla"], key=key,
                          record_hidden=record_hidden, graphs=graphs)


def cdlm(params, prompt_tokens, *, cfg: ModelConfig, spec: SamplerSpec,
         key=None):
    """The paper's student: exact block-causal KV cache, threshold parallel
    finalization, commit pass at block completion, early stop on EOS."""
    return run_block_loop(params, prompt_tokens, cfg=cfg, spec=spec,
                          strategy=STRATEGIES["cdlm"], key=key)


#: The ported decoders; the reference's other four are declared in
#: ``block_loop.STRATEGIES`` and refused (ROADMAP Queue 1 item 9).
SAMPLERS = {
    "vanilla": vanilla_blockwise,
    "cdlm": cdlm,
}
