"""Decoders of the port, as the JAX package's ``core/sampler.py`` names
them. Ported so far: ``vanilla_blockwise`` (greedy), the teacher decode
that also collects Alg. 1 trajectories. The CDLM student's decode is
served by ``serving.ContinuousEngine``."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.core.block_loop import SamplerSpec, _top1_loop


def vanilla_blockwise(params, prompt_tokens, *, cfg: ModelConfig,
                      spec: SamplerSpec, record_hidden: bool = False):
    """Alg. 1 teacher decoding: N = G steps, one token finalized per step,
    bidirectional full recompute. With ``record_hidden`` returns
    ``(SampleResult, finalized_at, hidden)``, the trajectory collector's
    output. Greedy only: ``spec.temperature > 0`` raises."""
    return _top1_loop(params, prompt_tokens, cfg=cfg, spec=spec,
                      record_hidden=record_hidden)
