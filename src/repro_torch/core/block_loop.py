"""Block-decode helpers of the CDLM strategy (paper §4.3), ported from the
JAX package's ``core/block_loop.py``: the sampler spec, the canvas, the
generation length, and the per-lane block forward that the continuous
engine is built on."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import masks
from repro_torch.kernels.decode_attn import (
    decode_attention,
    paged_decode_attention,
)
from repro_torch.models import forward


@dataclasses.dataclass(frozen=True)
class SamplerSpec:
    prompt_len: int             # prompt tokens in the canvas
    gen_len: int
    block_size: int
    conf_threshold: float = 0.9

    @property
    def n_blocks(self) -> int:
        return self.gen_len // self.block_size


def init_canvas(prompt_tokens: torch.Tensor, spec: SamplerSpec,
                cfg: ModelConfig) -> torch.Tensor:
    gen = torch.full((prompt_tokens.shape[0], spec.gen_len),
                     cfg.mask_token_id, dtype=prompt_tokens.dtype,
                     device=prompt_tokens.device)
    return torch.cat([prompt_tokens, gen], dim=1)


def _gen_lengths(tokens: torch.Tensor, spec: SamplerSpec, cfg: ModelConfig,
                 eos_id=None) -> torch.Tensor:
    """Tokens before the first EOS per lane; ``eos_id`` optionally
    overrides the config's stop token with a per-lane ``(b,)`` tensor."""
    gen = tokens[:, spec.prompt_len:]
    eos = cfg.eos_token_id if eos_id is None else eos_id[:, None]
    is_eos = gen == eos
    first = torch.argmax(is_eos.to(torch.int32), dim=-1)
    return torch.where(is_eos.any(-1), first,
                       torch.full_like(first, spec.gen_len))


def lane_block_forward(params, tokens, starts, kv_cache, *, cfg: ModelConfig,
                       spec: SamplerSpec, return_hidden: bool = False,
                       decode_attention_fn=decode_attention,
                       paged_decode_attention_fn=paged_decode_attention,
                       use_long_window: bool = False):
    """Block-causal cached forward where each lane decodes its own block.

    tokens: (b, T) canvases; starts: (b,) canvas coordinate of each lane's
    active block, which is also the lane's valid cache length; kv_cache: a
    dense ``core.cache.init_cache`` tuple or a ``core.cache.PagedCache``.
    Returns ``(logits (b, B, V), emissions)``, or the post-norm hidden
    ``(b, B, d)`` in place of the logits with ``return_hidden`` (the
    lm_head is then skipped).

    The JAX package vmaps a one-lane forward; here the lanes form one batch
    with per-lane positions and cache lengths. ``decode_attention_fn`` and
    ``paged_decode_attention_fn`` (default: the CUDA kernels' wrappers) are
    the attention of every cached forward on a dense and a paged cache;
    ``None`` takes the generic masked attention instead (on a paged cache,
    over the gathered dense view). ``use_long_window`` caps attention at
    ``cfg.long_context_window``.

    Exactness: under the block-causal mask a lane's output depends only on
    its own cache rows and its own block, so lanes at different block
    offsets share one batch without loss.
    """
    B = spec.block_size
    starts = torch.as_tensor(starts, dtype=torch.int64, device=tokens.device)
    pos = starts[:, None] + torch.arange(B, device=tokens.device)
    out = forward(params, tokens.gather(1, pos), cfg=cfg,
                  device=tokens.device, mode=masks.BLOCK_CAUSAL,
                  prompt_len=spec.prompt_len, block_size=B, positions=pos,
                  cache=kv_cache, cache_len=starts,
                  decode_attention_fn=decode_attention_fn,
                  paged_decode_attention_fn=paged_decode_attention_fn,
                  use_long_window=use_long_window,
                  return_logits=not return_hidden)
    return (out.hidden if return_hidden else out.logits), out.emissions
