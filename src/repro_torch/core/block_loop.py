"""Block-decode helpers (paper §4.3), ported from the JAX package's
``core/block_loop.py``: the sampler spec, the canvas, the generation
length, the per-lane block forward that the continuous engine is built on,
and the top-1 loop of the teacher decode (Alg. 1's trajectory
collector)."""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch import graphs as GR
from repro_torch.configs.base import ModelConfig
from repro_torch.core import diffusion as D
from repro_torch.core import masks
from repro_torch.kernels.block_attn import flash_block_attention
from repro_torch.kernels.decode_attn import (
    decode_attention,
    paged_decode_attention,
)
from repro_torch.models import forward, unembed_matrix


@dataclasses.dataclass(frozen=True)
class SamplerSpec:
    prompt_len: int             # prompt tokens in the canvas
    gen_len: int
    block_size: int
    conf_threshold: float = 0.9
    temperature: float = 0.0
    # Route greedy candidate selection through the fused unembed + select
    # kernel (no (b, ., V) logits); the top-1 loop then also runs its
    # full-canvas forwards through the block attention kernel
    fused_select: bool = False

    @property
    def n_blocks(self) -> int:
        return self.gen_len // self.block_size


class SampleResult(NamedTuple):
    tokens: torch.Tensor         # (b, P + G) final canvases
    steps: torch.Tensor          # (b,) refinement iterations
    n_model_calls: int           # forward passes
    gen_lengths: torch.Tensor    # (b,) tokens before the first EOS


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


def top1_step(params, tokens, start: int, *, cfg: ModelConfig,
              spec: SamplerSpec, w=None):
    """One step of the top-1 loop before its selection: a bidirectional
    forward over the whole canvases ``tokens`` (b, P+G), then the greedy
    candidates, their confidences and the post-norm hidden states of the
    block at canvas coordinate ``start``, each (b, B[, d]). With
    ``spec.fused_select`` the forward runs through the block attention
    kernel and the selection through the fused select kernel (``w``: the
    (V, d) unembedding); otherwise through the generic attention and the
    block's logits, as the JAX collector does. Call it under
    ``torch.no_grad()``."""
    B = spec.block_size
    if spec.fused_select:
        return _fused_pick(_canvas_hidden(params, tokens, cfg=cfg,
                                          spec=spec),
                           tokens, start, cfg=cfg, spec=spec, w=w)
    out = forward(params, tokens, cfg=cfg, device=tokens.device,
                  mode=masks.BIDIRECTIONAL, prompt_len=spec.prompt_len,
                  block_size=B, logits_slice=(start, start + B))
    bt = tokens[:, start:start + B]
    cand, conf = D.confidence_and_candidates(out.logits, bt,
                                             cfg.mask_token_id)
    return cand, conf, out.hidden[:, start:start + B]


def _canvas_hidden(params, tokens, *, cfg: ModelConfig, spec: SamplerSpec):
    """The fused top-1 step's forward: post-norm hidden states (b, P+G, d)
    of the whole canvases, bidirectional, through the block attention
    kernel (the collector captures it as a CUDA graph)."""
    return forward(params, tokens, cfg=cfg, device=tokens.device,
                   mode=masks.BIDIRECTIONAL, prompt_len=spec.prompt_len,
                   block_size=spec.block_size, return_logits=False,
                   prefill_attention_fn=flash_block_attention).hidden


def _fused_pick(hidden, tokens, start: int, *, cfg: ModelConfig,
                spec: SamplerSpec, w):
    """The fused top-1 step's selection from the canvas' hidden states:
    the block's candidates and confidences through the fused select
    kernel, and the block's hidden states."""
    B = spec.block_size
    hidden = hidden[:, start:start + B]
    cand, conf = D.confidence_and_candidates_fused(
        hidden, w, tokens[:, start:start + B], cfg.mask_token_id,
        softcap=cfg.final_logit_softcap)
    return cand, conf, hidden


def _top1_loop(params, prompt_tokens, *, cfg: ModelConfig, spec: SamplerSpec,
               record_hidden: bool, graphs: Optional[bool] = None):
    """N = G steps, one most-confident token finalized per step, each step a
    bidirectional forward over the whole canvas (the ``vanilla`` strategy,
    :func:`top1_step`), greedy only. Runs under ``torch.no_grad()``.

    With ``record_hidden`` also returns ``finalized_at`` (b, G) int32, the
    step at which each position was finalized (the monotone trajectory's
    exact encoding), and the fp32 hidden buffer (b, G, d): the teacher's
    last hidden state at each position's finalization.

    ``graphs``: None (the default) runs the fused step's forward as a CUDA
    graph over the canvas (captured once per call, its warm-up run serving
    as the first step's forward) on CUDA with ``spec.fused_select``, and
    eagerly otherwise; False runs it eagerly; True where it cannot apply
    raises. The selection after each forward runs eagerly either way.
    """
    if spec.temperature > 0:
        raise ValueError("sampled (temperature > 0) decoding is not ported "
                         "yet: ROADMAP Queue 1 item 7 (per-request "
                         "sampling)")
    graphable = spec.fused_select and prompt_tokens.device.type == "cuda"
    if graphs and not graphable:
        raise ValueError("graphs=True needs spec.fused_select and a CUDA "
                         "device")
    with torch.no_grad():
        tokens = init_canvas(prompt_tokens, spec, cfg)
        b = tokens.shape[0]
        P, B, G = spec.prompt_len, spec.block_size, spec.gen_len
        dev = tokens.device
        finalized_at = torch.full((b, G), -1, dtype=torch.int32, device=dev)
        hidden_buf = torch.zeros((b, G, cfg.d_model), dtype=torch.float32,
                                 device=dev)
        w = unembed_matrix(params, cfg) if spec.fused_select else None
        whole_block = torch.ones((1, B), dtype=torch.bool, device=dev)
        graph = None
        if graphable and graphs is not False:
            # the canvas is written in place below: the graph reads it at
            # its fixed address
            graph = GR.Graph(lambda: _canvas_hidden(params, tokens, cfg=cfg,
                                                    spec=spec))
        step = 0
        for blk in range(spec.n_blocks):
            start = P + blk * B
            for _ in range(B):
                if graph is None:
                    cand, conf, hidden = top1_step(params, tokens, start,
                                                   cfg=cfg, spec=spec, w=w)
                else:
                    full = graph.warm if step == 0 else graph.replay()
                    cand, conf, hidden = _fused_pick(full, tokens, start,
                                                     cfg=cfg, spec=spec, w=w)
                bt = tokens[:, start:start + B]
                sel = D.select_topk_in_block(conf, whole_block, 1)
                tokens[:, start:start + B] = torch.where(
                    sel, cand.to(tokens.dtype), bt)
                if record_hidden:
                    g0 = start - P
                    finalized_at[:, g0:g0 + B] = torch.where(
                        sel, step, finalized_at[:, g0:g0 + B])
                    hidden_buf[:, g0:g0 + B] = torch.where(
                        sel[..., None], hidden.float(),
                        hidden_buf[:, g0:g0 + B])
                step += 1
    res = SampleResult(tokens, torch.full((b,), step, dtype=torch.int32,
                                          device=dev), step,
                       _gen_lengths(tokens, spec, cfg))
    if record_hidden:
        return res, finalized_at, hidden_buf
    return res
