"""The block-decode loop (paper §4.3), ported from the JAX package's
``core/block_loop.py``: the sampler spec, the decode strategies, the
canvas, the generation length, the per-lane block forward that the
continuous engine is built on, and the loops of the paper's six decoders
(Tables 1-2), each greedy or sampled where the reference's is:

- the top-1 loop (``vanilla``: full recompute, one token a step; also
  Alg. 1's trajectory collector);
- the threshold loop under its four cache policies: ``none``
  (``fast_dllm``: a full-canvas forward every iteration), ``approx-dual``
  and ``approx-interval`` (``dual_cache``, ``interval_cache``: a stale
  whole-canvas cache refreshed at block starts or every
  ``cache_refresh_interval`` iterations) and ``exact-commit`` (``cdlm``:
  the exact block-causal cache with a commit pass, dense or paged);
- the greedy-next loop (``ar``: a causal prefill, then one cached token a
  step).

:func:`run_block_loop` dispatches over them. Its ``attention_fns`` name
the attention of every forward (default: the CUDA kernels' wrappers).

Sampled decoding draws from the reference's threefry streams
(:mod:`repro_torch.prng`), split in the reference's order, so its tokens
are the JAX package's. A scalar-temperature draw is shaped like the
reference's canvas logits ``(b, T, V)``; the port hashes the active
block's counters of that draw only (the selection reads nothing else),
and computes the lm_head over the active block only. The loops run
eagerly with one host read per iteration (the reference's ``while_loop``
condition; none in the greedy-next loop), apart from the collector's CUDA
graph."""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

import numpy as np

from repro_torch import graphs as GR
from repro_torch import prng
from repro_torch.configs.base import ModelConfig
from repro_torch.core import cache as C
from repro_torch.core import diffusion as D
from repro_torch.core import masks
from repro_torch.kernels.block_attn import flash_block_attention
from repro_torch.kernels.block_attn import ref as block_ref
from repro_torch.kernels.decode_attn import (
    decode_attention,
    paged_decode_attention,
)
from repro_torch.kernels.decode_attn import ref as decode_ref
from repro_torch.models import forward, unembed_matrix


@dataclasses.dataclass(frozen=True)
class SamplerSpec:
    prompt_len: int             # prompt tokens in the canvas
    gen_len: int
    block_size: int
    conf_threshold: float = 0.9
    temperature: float = 0.0
    early_stop: bool = True
    # approx-interval: refresh the stale cache every R iterations of a block
    cache_refresh_interval: int = 8
    # KV memory layout of the exact-commit policy (core.cache.CACHE_LAYOUTS)
    cache_layout: str = "dense"
    # Route greedy candidate selection through the fused unembed + select
    # kernel (no (b, ., V) logits); the top-1 loop then also runs its
    # full-canvas forwards through the block attention kernel. Sampled
    # decoding takes dense logits either way (its draw is logits-shaped).
    fused_select: bool = False

    @property
    def n_blocks(self) -> int:
        return self.gen_len // self.block_size


class SampleResult(NamedTuple):
    tokens: torch.Tensor         # (b, P + G) final canvases
    steps: torch.Tensor          # (b,) refinement iterations
    n_model_calls: int           # forward passes
    gen_lengths: torch.Tensor    # (b,) tokens before the first EOS


class LaneParams(NamedTuple):
    """Per-lane (= per-request) sampling parameters of the threshold loop,
    ``(b,)`` tensors on the canvas' device: lanes at ``temperature <= 0``
    take the greedy argmax, the others draw with their own key (advanced
    only on the lane's active iterations,
    :func:`repro_torch.core.diffusion.split_lane_keys`), so a lane decodes
    as it does alone whatever its batch."""
    temperature: torch.Tensor    # (b,) float32
    conf_threshold: torch.Tensor  # (b,) float32
    eos_id: torch.Tensor         # (b,) int64
    key: torch.Tensor            # (b, 2) int64 (uint32 values)


CACHE_POLICIES = ("none", "approx-dual", "approx-interval", "exact-commit",
                  "ar")
FINALIZE_RULES = ("top1", "threshold", "greedy-next")


@dataclasses.dataclass(frozen=True)
class DecodeStrategy:
    """Declarative description of a decoding algorithm."""
    name: str
    attn_mode: str              # masks.BIDIRECTIONAL | BLOCK_CAUSAL | CAUSAL
    cache_policy: str           # see CACHE_POLICIES
    finalize: str               # see FINALIZE_RULES

    def __post_init__(self):
        if self.cache_policy not in CACHE_POLICIES:
            raise ValueError(f"unknown cache policy {self.cache_policy!r}")
        if self.finalize not in FINALIZE_RULES:
            raise ValueError(f"unknown finalize rule {self.finalize!r}")


#: The six decoding algorithms of the paper's Tables 1-2, as the JAX
#: package declares them.
STRATEGIES = {
    "vanilla": DecodeStrategy("vanilla", masks.BIDIRECTIONAL, "none", "top1"),
    "fast_dllm": DecodeStrategy("fast_dllm", masks.BIDIRECTIONAL, "none",
                                "threshold"),
    "dual_cache": DecodeStrategy("dual_cache", masks.BIDIRECTIONAL,
                                 "approx-dual", "threshold"),
    "interval_cache": DecodeStrategy("interval_cache", masks.BIDIRECTIONAL,
                                     "approx-interval", "threshold"),
    "cdlm": DecodeStrategy("cdlm", masks.BLOCK_CAUSAL, "exact-commit",
                           "threshold"),
    "ar": DecodeStrategy("ar", masks.CAUSAL, "ar", "greedy-next"),
}

#: (cache policy, finalize rule) pairs the port runs: the six decoders'.
PORTED = {(s.cache_policy, s.finalize) for s in STRATEGIES.values()}


class AttentionFns(NamedTuple):
    """The attention of every forward of a decode: ``prefill`` for
    full-sequence forwards (prompt prefill, full-canvas recompute, cache
    refresh), ``decode`` and ``paged_decode`` for cached forwards on a
    dense and a paged cache. :data:`KERNELS` (the default) are the CUDA
    kernels' wrappers; :data:`PLAIN` their plain PyTorch versions, which
    a caller names to hold a decode's kernel path against its plain one.
    A cached forward under a ``cache_valid`` mask (the approx policies)
    takes the generic attention either way, as in the reference."""
    prefill: Callable = flash_block_attention
    decode: Callable = decode_attention
    paged_decode: Callable = paged_decode_attention


KERNELS = AttentionFns()
PLAIN = AttentionFns(block_ref.block_attention, decode_ref.decode_attention,
                     decode_ref.paged_decode_attention)


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


def _canvas_index(b: int, T: int, V: int, start: int, B: int, device):
    """The flat counters of a ``(b, T, V)`` draw at the block ``[start,
    start + B)`` of every lane: ``(b, B, V)``, int32 where they fit."""
    dt = torch.int32 if b * T * V <= 1 << 31 else torch.int64
    rows = ((torch.arange(b, device=device)[:, None] * T + start
             + torch.arange(B, device=device)) * V).to(dt)
    return rows[..., None] + torch.arange(V, dtype=dt, device=device)


def _canvas_draw(logits, tokens, start: int, T: int, temperature: float,
                 key, cfg: ModelConfig):
    """Candidates and confidences of the block ``[start, start + B)`` from
    its logits ``(b, B, V)``, the draw taken as the reference takes it over
    the whole canvas' ``(b, T, V)`` logits (the block's counters only)."""
    b, B, V = logits.shape
    return D.confidence_and_candidates(
        logits, tokens, cfg.mask_token_id, temperature, key,
        draw_shape=(b, T, V),
        draw_index=_canvas_index(b, T, V, start, B, logits.device))


def top1_step(params, tokens, start: int, *, cfg: ModelConfig,
              spec: SamplerSpec, w=None, key=None,
              prefill_fn=flash_block_attention):
    """One step of the top-1 loop before its selection: a bidirectional
    forward over the whole canvases ``tokens`` (b, P+G), then the
    candidates, their confidences and the post-norm hidden states of the
    block at canvas coordinate ``start``, each (b, B[, d]). With
    ``spec.fused_select`` the forward runs through ``prefill_fn`` (the
    block attention kernel; ``w``: the (V, d) unembedding); otherwise
    through the generic attention, as the JAX collector does. Greedy
    selection then goes through the fused select kernel
    (``spec.fused_select``) or the block's logits; a sampled step
    (``spec.temperature > 0`` and ``key``) draws from the block's logits
    as the reference draws over the canvas. Call it under
    ``torch.no_grad()``."""
    B = spec.block_size
    if spec.fused_select:
        return _fused_pick(_canvas_hidden(params, tokens, cfg=cfg,
                                          spec=spec, prefill_fn=prefill_fn),
                           tokens, start, cfg=cfg, spec=spec, w=w, key=key)
    out = forward(params, tokens, cfg=cfg, device=tokens.device,
                  mode=masks.BIDIRECTIONAL, prompt_len=spec.prompt_len,
                  block_size=B, logits_slice=(start, start + B))
    bt = tokens[:, start:start + B]
    if spec.temperature > 0 and key is not None:
        cand, conf = _canvas_draw(out.logits, bt, start, tokens.shape[1],
                                  spec.temperature, key, cfg)
    else:
        cand, conf = D.confidence_and_candidates(out.logits, bt,
                                                 cfg.mask_token_id)
    return cand, conf, out.hidden[:, start:start + B]


def _canvas_hidden(params, tokens, *, cfg: ModelConfig, spec: SamplerSpec,
                   prefill_fn=flash_block_attention):
    """The fused top-1 step's forward: post-norm hidden states (b, P+G, d)
    of the whole canvases, bidirectional, through ``prefill_fn`` (the block
    attention kernel; the collector captures it as a CUDA graph)."""
    return forward(params, tokens, cfg=cfg, device=tokens.device,
                   mode=masks.BIDIRECTIONAL, prompt_len=spec.prompt_len,
                   block_size=spec.block_size, return_logits=False,
                   prefill_attention_fn=prefill_fn).hidden


def _fused_pick(hidden, tokens, start: int, *, cfg: ModelConfig,
                spec: SamplerSpec, w, key=None):
    """The fused top-1 step's selection from the canvas' hidden states: the
    block's candidates and confidences (greedy: through the fused select
    kernel; sampled: the block's logits and the canvas-shaped draw), and
    the block's hidden states."""
    B = spec.block_size
    hidden = hidden[:, start:start + B]
    bt = tokens[:, start:start + B]
    if spec.temperature > 0 and key is not None:
        logits = D.dense_logits(hidden, w, cfg.final_logit_softcap)
        cand, conf = _canvas_draw(logits, bt, start, tokens.shape[1],
                                  spec.temperature, key, cfg)
        return cand, conf, hidden
    cand, conf = D.confidence_and_candidates_fused(
        hidden, w, bt, cfg.mask_token_id, softcap=cfg.final_logit_softcap)
    return cand, conf, hidden


def _top1_loop(params, prompt_tokens, *, cfg: ModelConfig, spec: SamplerSpec,
               record_hidden: bool, key=None, graphs: Optional[bool] = None,
               fns: AttentionFns = KERNELS):
    """N = G steps, one most-confident token finalized per step, each step a
    bidirectional forward over the whole canvas (the ``vanilla`` strategy,
    :func:`top1_step`). Runs under ``torch.no_grad()``. ``key`` (default
    ``PRNGKey(0)``) is split once per step, as in the reference; a sampled
    step (``spec.temperature > 0``) draws with the second half.

    With ``record_hidden`` also returns ``finalized_at`` (b, G) int32, the
    step at which each position was finalized (the monotone trajectory's
    exact encoding), and the fp32 hidden buffer (b, G, d): the teacher's
    last hidden state at each position's finalization.

    ``graphs``: None (the default) runs the fused step's forward as a CUDA
    graph over the canvas (captured once per call, its warm-up run serving
    as the first step's forward) on CUDA with ``spec.fused_select``, and
    eagerly otherwise; False runs it eagerly; True where it cannot apply
    raises. The selection after each forward (a sampled step's logits and
    draw too) runs eagerly either way.
    """
    graphable = spec.fused_select and prompt_tokens.device.type == "cuda"
    if graphs and not graphable:
        raise ValueError("graphs=True needs spec.fused_select and a CUDA "
                         "device")
    sampled = spec.temperature > 0
    with torch.no_grad():
        tokens = init_canvas(prompt_tokens, spec, cfg)
        b = tokens.shape[0]
        P, B, G = spec.prompt_len, spec.block_size, spec.gen_len
        dev = tokens.device
        key = prng.key(0, dev) if key is None else key.to(dev)
        finalized_at = torch.full((b, G), -1, dtype=torch.int32, device=dev)
        hidden_buf = torch.zeros((b, G, cfg.d_model), dtype=torch.float32,
                                 device=dev)
        w = unembed_matrix(params, cfg) if spec.fused_select else None
        whole_block = torch.ones((1, B), dtype=torch.bool, device=dev)
        graph = None
        if graphable and graphs is not False:
            # the canvas is written in place below: the graph reads it at
            # its fixed address
            graph = GR.Graph(lambda: _canvas_hidden(
                params, tokens, cfg=cfg, spec=spec, prefill_fn=fns.prefill))
        step = 0
        for blk in range(spec.n_blocks):
            start = P + blk * B
            for _ in range(B):
                sub = None
                if sampled:      # a greedy step never reads its subkey
                    key, sub = prng.split(key)
                if graph is None:
                    cand, conf, hidden = top1_step(params, tokens, start,
                                                   cfg=cfg, spec=spec, w=w,
                                                   key=sub,
                                                   prefill_fn=fns.prefill)
                else:
                    full = graph.warm if step == 0 else graph.replay()
                    cand, conf, hidden = _fused_pick(full, tokens, start,
                                                     cfg=cfg, spec=spec, w=w,
                                                     key=sub)
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


# ---------------------------------------------------------------------------
# Finalization family: threshold (Fast-dLLM, the cache baselines, CDLM)
# ---------------------------------------------------------------------------
def _finalize(tokens, start: int, cand, conf, tau, active) -> None:
    """The threshold rule in block coordinates: the active lanes' positions
    of the block ``[start, start + B)`` whose confidence reaches ``tau``
    (scalar or (b, 1)), and always the most confident masked one, take
    their candidates; written into ``tokens`` in place."""
    B = cand.shape[1]
    bt = tokens[:, start:start + B]
    whole = torch.ones((1, B), dtype=torch.bool, device=tokens.device)
    sel = D.select_threshold_in_block(conf, whole, tau) & active[:, None]
    tokens[:, start:start + B] = torch.where(sel, cand.to(bt.dtype), bt)


def _threshold_update(tokens, logits, start: int, spec: SamplerSpec,
                      cfg: ModelConfig, key, active) -> None:
    """The reference's canvas-coordinate threshold update, the scalar
    sampled path: the draw is shaped like the ``(b, T, V)`` canvas logits
    (zero outside the block), and only the block's elements are hashed.
    Writes the finalized tokens into ``tokens`` in place."""
    B = spec.block_size
    cand, conf = _canvas_draw(logits, tokens[:, start:start + B], start,
                              tokens.shape[1], spec.temperature, key, cfg)
    _finalize(tokens, start, cand, conf, spec.conf_threshold, active)


def _block_candidates(params, cfg: ModelConfig, spec: SamplerSpec, net,
                      block_tokens, key):
    """(cand, conf) of the active block in block coordinates (b, B): ``net``
    is the block forward's hidden states with ``spec.fused_select`` (the
    fused select kernel reads them) and its logits otherwise."""
    if spec.fused_select:
        return D.confidence_and_candidates_fused(
            net, unembed_matrix(params, cfg), block_tokens,
            cfg.mask_token_id, spec.temperature, key,
            softcap=cfg.final_logit_softcap)
    return D.confidence_and_candidates(net, block_tokens, cfg.mask_token_id,
                                       spec.temperature, key)


def _threshold_block_update(params, cfg: ModelConfig, spec: SamplerSpec,
                            tokens, net, start: int, key, active) -> None:
    """Block-coordinate threshold finalization (the scalar greedy path):
    select on the block's (b, B) candidates, write the finalized tokens
    into ``tokens`` in place."""
    bt = tokens[:, start:start + spec.block_size]
    cand, conf = _block_candidates(params, cfg, spec, net, bt, key)
    _finalize(tokens, start, cand, conf, spec.conf_threshold, active)


def _block_candidates_per_lane(params, cfg: ModelConfig, spec: SamplerSpec,
                               net, block_tokens, lanes: LaneParams, subs, *,
                               fused: bool, sampled: bool):
    """(cand, conf) of the active block under per-lane params: ``fused``
    (all-greedy batches) through the fused select kernel from the hidden
    states, otherwise per lane from the logits (greedy lanes argmax,
    sampled lanes draw with their subkeys ``subs (b, 2)``)."""
    if fused:
        return D.confidence_and_candidates_fused(
            net, unembed_matrix(params, cfg), block_tokens,
            cfg.mask_token_id, softcap=cfg.final_logit_softcap)
    return D.confidence_and_candidates_per_lane(
        net, block_tokens, cfg.mask_token_id, lanes.temperature,
        subs if sampled else None)


def _threshold_lane_update(params, cfg: ModelConfig, spec: SamplerSpec,
                           tokens, net, start: int, lanes: LaneParams, subs,
                           active, *, fused: bool, sampled: bool) -> None:
    """Block-coordinate threshold finalization with per-lane params: the
    lane's temperature picks greedy or sampled candidates, its τ the
    threshold. Writes into ``tokens`` in place."""
    bt = tokens[:, start:start + spec.block_size]
    cand, conf = _block_candidates_per_lane(params, cfg, spec, net, bt,
                                            lanes, subs, fused=fused,
                                            sampled=sampled)
    _finalize(tokens, start, cand, conf, lanes.conf_threshold[:, None],
              active)


def _commit_any(kv_cache, emissions, offset: int, b: int):
    """Layout-agnostic whole-batch commit at a shared offset."""
    if isinstance(kv_cache, C.PagedCache):
        return C.commit_rows(kv_cache, emissions, offset, np.ones((b,), bool))
    return C.commit(kv_cache, emissions, offset)


def _init_exact_cache(cfg: ModelConfig, b: int, S: int, spec: SamplerSpec,
                      device):
    """The exact-commit cache in the layout ``spec.cache_layout`` selects.
    The paged one is a dense-equivalent pool with every lane's pages
    assigned up front (the single-batch loop is the layout's
    bit-equivalence harness; page-at-a-time admission is the engine's)."""
    if spec.cache_layout == C.DENSE:
        return C.init_cache(cfg, b, S, device=device)
    if spec.cache_layout != C.PAGED:
        raise ValueError(f"unknown cache layout {spec.cache_layout!r} "
                         f"(expected one of {C.CACHE_LAYOUTS})")
    page = spec.block_size
    n_tables = -(-S // page)
    paged = C.init_paged_cache(cfg, b, n_tables * page, n_pages=b * n_tables,
                               page_size=page, device=device)
    C.alloc(paged, np.ones((b,), bool), 0, S)
    return paged


def _refresh_cache(params, tokens, kv_cache, *, cfg: ModelConfig,
                   spec: SamplerSpec, fns: AttentionFns) -> None:
    """The approx policies' refresh: a bidirectional forward over the whole
    canvases through ``fns.prefill``, every row's KV committed at offset 0
    (in place). Only the emissions are read, so the lm_head is skipped."""
    out = forward(params, tokens, cfg=cfg, device=tokens.device,
                  mode=masks.BIDIRECTIONAL, prompt_len=spec.prompt_len,
                  block_size=spec.block_size, return_logits=False,
                  prefill_attention_fn=fns.prefill)
    C.commit(kv_cache, out.emissions, 0)


def _block_pos_mask(T: int, start: int, size: int, device) -> torch.Tensor:
    pos = torch.arange(T, device=device)
    return (pos >= start) & (pos < start + size)


def _block_forward(params, tokens, start: int, kv_cache, *,
                   cfg: ModelConfig, spec: SamplerSpec,
                   strategy: DecodeStrategy, fns: AttentionFns,
                   return_hidden: bool):
    """The forward of one threshold iteration for the block at canvas
    coordinate ``start`` under ``strategy.cache_policy``: ``(the block's
    post-norm hidden (b, B, d) with return_hidden, else its logits (b, B,
    V); emissions)``. ``none``: the whole canvases through
    ``fns.prefill``, the lm_head over the block only; the approx
    policies: the block against the stale cache with the block's own rows
    invalid (``cache_valid``, the generic attention); ``exact-commit``:
    the block against the exact cache through the layout's decode
    attention."""
    policy, B, dev = strategy.cache_policy, spec.block_size, tokens.device
    if policy == "exact-commit":
        starts = torch.full((tokens.shape[0],), start, dtype=torch.int64,
                            device=dev)
        return lane_block_forward(params, tokens, starts, kv_cache, cfg=cfg,
                                  spec=spec, return_hidden=return_hidden,
                                  decode_attention_fn=fns.decode,
                                  paged_decode_attention_fn=fns.paged_decode)
    if policy == "none":
        out = forward(params, tokens, cfg=cfg, device=dev,
                      mode=strategy.attn_mode, prompt_len=spec.prompt_len,
                      block_size=B, prefill_attention_fn=fns.prefill,
                      logits_slice=(start, start + B),
                      return_logits=not return_hidden)
        return ((out.hidden[:, start:start + B] if return_hidden
                 else out.logits), out.emissions)
    out = forward(params, tokens[:, start:start + B], cfg=cfg, device=dev,
                  mode=strategy.attn_mode, prompt_len=spec.prompt_len,
                  block_size=B, positions=start + torch.arange(B, device=dev),
                  cache=kv_cache, cache_len=start,
                  cache_valid=~_block_pos_mask(tokens.shape[1], start, B,
                                               dev),
                  return_logits=not return_hidden)
    return out.hidden if return_hidden else out.logits, out.emissions


def _threshold_loop(params, prompt_tokens, *, cfg: ModelConfig,
                    spec: SamplerSpec, strategy: DecodeStrategy, key,
                    lane_params: Optional[LaneParams] = None,
                    lane_sampled: bool = False,
                    fns: AttentionFns = KERNELS) -> SampleResult:
    """The threshold loop: per block the refinement iterations (each a
    forward and the threshold rule) while a running lane holds a mask
    token in the block and fewer than B ran. One host read per iteration
    (the reference's ``while_loop`` condition). The forward of an
    iteration, by ``strategy.cache_policy``:

    - ``none`` (``fast_dllm``): the whole canvases through ``fns.prefill``,
      no cache, no prefill; the lm_head over the active block only;
    - ``approx-dual``, ``approx-interval``: the block against a dense
      whole-canvas cache, stale everywhere but the block (``cache_valid``,
      the generic attention), filled by one refresh before the first block
      (:func:`_refresh_cache`; one call). ``approx-dual`` refreshes at
      every later block's start (one call each), ``approx-interval``
      before the iterations ``it`` with ``it % R == R - 1`` (R =
      ``spec.cache_refresh_interval``; counted as no call, as in the
      reference);
    - ``exact-commit`` (``cdlm``): the prompt prefilled block-causally
      through ``fns.prefill`` and committed, the block against the exact
      cache through the layout's decode attention, and a commit pass at
      the block's end.

    Selection as in the reference: per-lane params (``lane_params``) in
    block coordinates with per-lane streams (``lane_sampled``: some lane
    draws, so the forwards carry logits); scalar greedy in block
    coordinates (through the fused select kernel with
    ``spec.fused_select``); scalar sampled with the canvas-shaped draw."""
    policy = strategy.cache_policy
    with torch.no_grad():
        tokens = init_canvas(prompt_tokens, spec, cfg)
        b, T = tokens.shape
        P, B, R = spec.prompt_len, spec.block_size, spec.cache_refresh_interval
        dev = tokens.device
        lanes = lane_params is not None
        blockwise = True if lanes else spec.temperature <= 0
        fused = spec.fused_select and (not lane_sampled if lanes
                                       else blockwise)
        key_state = lane_params.key if lanes else key
        done = torch.zeros((b,), dtype=torch.bool, device=dev)
        steps = torch.zeros((b,), dtype=torch.int32, device=dev)
        kv_cache, calls = None, 0
        if policy == "exact-commit":
            kv_cache = _init_exact_cache(cfg, b, T, spec, dev)
            out = forward(params, tokens[:, :P], cfg=cfg, device=dev,
                          mode=strategy.attn_mode, prompt_len=P,
                          block_size=B, return_logits=False,
                          prefill_attention_fn=fns.prefill)
            _commit_any(kv_cache, out.emissions, 0, b)
            calls = 1
        elif policy != "none":
            kv_cache = C.init_cache(cfg, b, T, device=dev)
            _refresh_cache(params, tokens, kv_cache, cfg=cfg, spec=spec,
                           fns=fns)
            calls = 1

        for blk in range(spec.n_blocks):
            start = P + blk * B

            def block_out(return_hidden):
                return _block_forward(params, tokens, start, kv_cache,
                                      cfg=cfg, spec=spec, strategy=strategy,
                                      fns=fns, return_hidden=return_hidden)

            if policy == "approx-dual" and blk > 0:
                _refresh_cache(params, tokens, kv_cache, cfg=cfg, spec=spec,
                               fns=fns)
                calls += 1
            for it in range(B):
                masked = (tokens[:, start:start + B]
                          == cfg.mask_token_id).any(-1)
                active = masked & ~done
                if not bool(active.any()):
                    break
                if lanes:
                    key_state, sub = D.split_lane_keys(key_state, active)
                else:
                    key_state, sub = prng.split(key_state)
                if policy == "approx-interval" and it % R == R - 1:
                    _refresh_cache(params, tokens, kv_cache, cfg=cfg,
                                   spec=spec, fns=fns)
                net, _ = block_out(fused)
                if lanes:
                    _threshold_lane_update(params, cfg, spec, tokens, net,
                                           start, lane_params, sub, active,
                                           fused=fused, sampled=lane_sampled)
                elif blockwise:
                    _threshold_block_update(params, cfg, spec, tokens, net,
                                            start, sub, active)
                else:
                    _threshold_update(tokens, net, start, spec, cfg, sub,
                                      active)
                steps += active.to(torch.int32)
                calls += 1
            if policy == "exact-commit":
                # commit pass: recompute the finalized block's KV exactly
                _, emissions = block_out(True)
                _commit_any(kv_cache, emissions, start, b)
                calls += 1
            if spec.early_stop:
                eos = (lane_params.eos_id[:, None] if lanes
                       else cfg.eos_token_id)
                done |= (tokens[:, start:start + B] == eos).any(-1)
    return SampleResult(tokens, steps, calls,
                        _gen_lengths(tokens, spec, cfg,
                                     eos_id=(lane_params.eos_id if lanes
                                             else None)))


# ---------------------------------------------------------------------------
# Finalization family: greedy-next (the AR baseline)
# ---------------------------------------------------------------------------
def _greedy_next_loop(params, prompt_tokens, *, cfg: ModelConfig,
                      spec: SamplerSpec, strategy: DecodeStrategy,
                      fns: AttentionFns = KERNELS) -> SampleResult:
    """Autoregressive greedy decode with a KV cache: the prompt prefilled
    under ``strategy.attn_mode`` (causal) through ``fns.prefill`` and
    committed, the logits of its last row only; then ``gen_len`` steps,
    each the argmax of the last logits (first occurrence; EOS once a lane
    is done), one cached forward of that token through ``fns.decode`` and
    its KV committed. ``steps`` counts a lane's steps before its EOS,
    ``calls`` is ``1 + gen_len`` (the reference's ``fori_loop``, which also
    runs the last step's forward); ``spec.early_stop`` changes nothing,
    as in the reference. No host read."""
    with torch.no_grad():
        tokens = init_canvas(prompt_tokens, spec, cfg)
        b, T = tokens.shape
        P = spec.prompt_len
        dev = tokens.device
        kv_cache = C.init_cache(cfg, b, T, device=dev)
        out = forward(params, tokens[:, :P], cfg=cfg, device=dev,
                      mode=strategy.attn_mode,
                      prefill_attention_fn=fns.prefill,
                      logits_slice=(P - 1, P))
        C.commit(kv_cache, out.emissions, 0)
        last = out.logits[:, -1]
        eos = torch.full((b,), cfg.eos_token_id, dtype=tokens.dtype,
                         device=dev)
        done = torch.zeros((b,), dtype=torch.bool, device=dev)
        steps = torch.zeros((b,), dtype=torch.int32, device=dev)
        for i in range(spec.gen_len):
            pos = P + i
            nxt = torch.where(done, eos, torch.argmax(last, -1).to(
                tokens.dtype))
            tokens[:, pos] = nxt
            steps += (~done).to(torch.int32)
            done |= nxt == eos
            out = forward(params, nxt[:, None], cfg=cfg, device=dev,
                          mode=strategy.attn_mode, cache=kv_cache,
                          cache_len=pos, decode_attention_fn=fns.decode)
            C.commit(kv_cache, out.emissions, pos)
            last = out.logits[:, -1]
    return SampleResult(tokens, steps, 1 + spec.gen_len,
                        _gen_lengths(tokens, spec, cfg))


def run_block_loop(params, prompt_tokens, *, cfg: ModelConfig,
                   spec: SamplerSpec, strategy: DecodeStrategy, key=None,
                   record_hidden: bool = False,
                   lane_params: Optional[LaneParams] = None,
                   lane_sampled: bool = False,
                   graphs: Optional[bool] = None,
                   attention_fns: AttentionFns = KERNELS):
    """Decode ``prompt_tokens`` (b, P) with ``strategy`` over the block
    grid; returns :class:`SampleResult`, with ``record_hidden`` (top-1
    only) also the trajectory encoding ``(finalized_at, hidden)``.

    ``key`` (default ``PRNGKey(0)``) is the scalar path's stream;
    ``lane_params`` switches the threshold loop to per-lane params, with
    ``lane_sampled`` set when some lane draws. ``graphs`` is the top-1
    loop's (:func:`_top1_loop`). ``attention_fns`` is the attention of
    every forward (:class:`AttentionFns`; default the CUDA kernels',
    :data:`PLAIN` the plain versions). A strategy whose (cache policy,
    finalize rule) pair is none of :data:`STRATEGIES`' raises."""
    if lane_params is not None and strategy.finalize != "threshold":
        raise ValueError(
            "per-request sampling params (lane_params) require a "
            f"threshold-finalize strategy; {strategy.name!r} uses "
            f"{strategy.finalize!r}")
    if spec.cache_layout != C.DENSE and strategy.cache_policy != "exact-commit":
        raise ValueError(
            f"cache_layout={spec.cache_layout!r} requires the 'exact-commit' "
            f"cache policy (strategy {strategy.name!r} uses "
            f"{strategy.cache_policy!r}); approx/ar policies rewrite "
            "whole-canvas KV, so paging buys nothing")
    if record_hidden and strategy.finalize != "top1":
        raise ValueError("record_hidden requires the 'top1' finalize rule "
                         f"(strategy {strategy.name!r} uses "
                         f"{strategy.finalize!r})")
    if (strategy.cache_policy, strategy.finalize) not in PORTED:
        raise ValueError(
            f"strategy {strategy.name!r} ({strategy.cache_policy!r} cache, "
            f"{strategy.finalize!r} finalize) is none of the six decoders "
            f"(block_loop.STRATEGIES: {', '.join(STRATEGIES)})")
    key = (prng.key(0, prompt_tokens.device) if key is None
           else key.to(prompt_tokens.device))
    if strategy.finalize == "top1":
        return _top1_loop(params, prompt_tokens, cfg=cfg, spec=spec,
                          record_hidden=record_hidden, key=key,
                          graphs=graphs, fns=attention_fns)
    if strategy.finalize == "threshold":
        return _threshold_loop(params, prompt_tokens, cfg=cfg, spec=spec,
                               strategy=strategy, key=key,
                               lane_params=lane_params,
                               lane_sampled=lane_sampled, fns=attention_fns)
    return _greedy_next_loop(params, prompt_tokens, cfg=cfg, spec=spec,
                             strategy=strategy, fns=attention_fns)
