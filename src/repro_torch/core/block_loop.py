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
and computes the lm_head over the active block only.

A decode reads and writes a :class:`DecodeState`: the canvases, the cache
and every vector and offset of the loops as device tensors (the active
block's start and the AR step's position too), so a step reads nothing
of the host. The host loop keeps the reference's control: one read of
``active`` per threshold iteration (its ``while_loop`` condition; none in
the greedy-next loop), and it schedules the prefill, the refreshes and
the commit passes. Each step it runs goes through a replay hook,
``replay(name, fn)`` (``repro_torch.graphs``): :func:`run_block_loop`
runs eagerly by default (the top-1 loop's forward a CUDA graph captured
per call, the collector's), and the static engine passes its own state
and a hook that captures each step as a CUDA graph once per engine and
replays it, the port's counterpart of the reference's ``jax.jit`` of the
sampler. Graph and eager run the same code."""
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
from repro_torch.kernels.elementwise import ElementwiseFns
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
    # prefix embeds (internvl2's patches) before the canvas: canvas
    # coordinate c sits at absolute sequence position c + pos_offset
    pos_offset: int = 0

    @property
    def n_blocks(self) -> int:
        return self.gen_len // self.block_size

    @property
    def full_prompt_len(self) -> int:
        return self.prompt_len + self.pos_offset


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
    """The kernels of every forward of a decode: the attention, ``prefill``
    for full-sequence forwards (prompt prefill, full-canvas recompute, cache
    refresh), ``decode`` and ``paged_decode`` for cached forwards on a
    dense and a paged cache, and ``elementwise``, the fused passes between
    the matmuls (``forward``'s ``elementwise_fns``; None: the plain ops).
    :data:`KERNELS` (the default) are the CUDA kernels' wrappers;
    :data:`PLAIN` the plain PyTorch versions and ops, which a caller names
    to hold a decode's kernel path against its plain one. A cached forward
    under a ``cache_valid`` mask (the approx policies) takes the generic
    attention either way, as in the reference."""
    prefill: Callable = flash_block_attention
    decode: Callable = decode_attention
    paged_decode: Callable = paged_decode_attention
    elementwise: Optional[ElementwiseFns] = ElementwiseFns()


KERNELS = AttentionFns()
PLAIN = AttentionFns(block_ref.block_attention, decode_ref.decode_attention,
                     decode_ref.paged_decode_attention, None)


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


class DecodeState:
    """The device buffers one decode of ``b`` lanes reads and writes: the
    canvases ``tokens`` (b, P+G), the ``cache`` its policy needs (none for
    ``none``; the dense whole-canvas cache for the approx policies and
    ``ar``; the exact cache in ``spec.cache_layout`` for
    ``exact-commit``; each of ``spec.pos_offset + P + G`` rows), the
    scalar stream's ``key``, the per-lane ``done``, ``steps`` and
    ``active`` vectors, the per-lane sampling params ``lanes``
    (:class:`LaneParams`), the active block's ``start`` and its absolute
    start ``astart`` (``start + spec.pos_offset``) and the AR step's
    position ``pos`` (0-dim int64), the AR step's ``last`` logits, and
    the request extras ``extras`` (:func:`extras_shapes`: whisper's
    ``encoder_embeds``, internvl2's ``prefix_embeds``; fp32, as the
    reference takes them), which every forward that reads them reads
    from these buffers.

    :func:`run_block_loop` makes one per call unless it is given one. The
    static engine allocates one for its life and loads each batch into it
    in place (:meth:`load`), so the CUDA graphs of its decode read every
    buffer at one address; a step reads no offset as a Python int."""

    def __init__(self, cfg: ModelConfig, spec: SamplerSpec,
                 strategy: DecodeStrategy, b: int, device,
                 dtype=torch.int64):
        dev = torch.device(device)
        T = spec.prompt_len + spec.gen_len
        S = T + spec.pos_offset
        policy = strategy.cache_policy
        self.mask_id = cfg.mask_token_id
        self.block_size = spec.block_size
        self.tokens = torch.full((b, T), cfg.mask_token_id, dtype=dtype,
                                 device=dev)
        self.cache = None
        if policy == "exact-commit":
            self.cache = _init_exact_cache(cfg, b, S, spec, dev)
            if isinstance(self.cache, C.PagedCache):
                self.cache.device_table()   # its one upload, before any step
        elif policy != "none":
            self.cache = C.init_cache(cfg, b, S, device=dev)
        self.key = torch.zeros((2,), dtype=torch.int64, device=dev)
        self.done = torch.zeros((b,), dtype=torch.bool, device=dev)
        self.steps = torch.zeros((b,), dtype=torch.int32, device=dev)
        self.active = torch.zeros((b,), dtype=torch.bool, device=dev)
        self.start = torch.zeros((), dtype=torch.int64, device=dev)
        self.astart = torch.zeros((), dtype=torch.int64, device=dev)
        self.pos = torch.zeros((), dtype=torch.int64, device=dev)
        self.extras = {k: torch.zeros((b, *shape), dtype=torch.float32,
                                      device=dev)
                       for k, shape in extras_shapes(cfg, spec).items()}
        self.last = (torch.zeros((b, cfg.vocab_size), dtype=torch.float32,
                                 device=dev) if policy == "ar" else None)
        self.lanes = LaneParams(
            temperature=torch.zeros((b,), dtype=torch.float32, device=dev),
            conf_threshold=torch.zeros((b,), dtype=torch.float32,
                                       device=dev),
            eos_id=torch.zeros((b,), dtype=torch.int64, device=dev),
            key=torch.zeros((b, 2), dtype=torch.int64, device=dev))

    def cache_buffers(self):
        """The cache's buffers: K/V (a paged cache's pools) and recurrent
        state leaves alike."""
        if self.cache is None:
            return []
        slots = (self.cache.slots if isinstance(self.cache, C.PagedCache)
                 else self.cache)
        return [buf for slot in slots for buf in slot.values()]

    def load(self, prompt_tokens, key, lanes: Optional[LaneParams] = None,
             extras: Optional[dict] = None):
        """A fresh decode of ``prompt_tokens`` (b, P) on the device, in
        place: the canvases, a zeroed cache (a paged one keeps its pages),
        ``done``, ``steps``, ``active``, the offsets, the scalar ``key``,
        where given the per-lane params, and the request ``extras`` (b,
        ...) into their buffers, whose keys and shapes they must match."""
        b, P = prompt_tokens.shape
        if b != self.tokens.shape[0]:
            raise ValueError(f"{b} prompts for a decode state of "
                             f"{self.tokens.shape[0]} lanes")
        extras = extras or {}
        if set(extras) != set(self.extras):
            raise ValueError(f"request extras {sorted(extras)}; this "
                             f"decode takes {sorted(self.extras)}")
        for k, buf in self.extras.items():
            value = torch.as_tensor(extras[k], device=buf.device)
            if value.shape != buf.shape:
                raise ValueError(f"{k} of shape {tuple(value.shape)}, "
                                 f"expected {tuple(buf.shape)}")
            buf.copy_(value)
        self.tokens[:, :P].copy_(prompt_tokens)
        self.tokens[:, P:].fill_(self.mask_id)
        for buf in self.cache_buffers() + [self.done, self.steps,
                                           self.active, self.start,
                                           self.astart, self.pos]:
            buf.zero_()
        self.key.copy_(key)
        if lanes is not None:
            for buf, value in zip(self.lanes, lanes):
                buf.copy_(value)

    def positions(self) -> torch.Tensor:
        """(b, B) canvas positions of the active block."""
        return _block_positions(self.start, self.block_size,
                                self.tokens.shape[0], self.tokens.device)

    def block(self) -> torch.Tensor:
        """The active block's tokens (b, B)."""
        return self.tokens.gather(1, self.positions())

    def refresh_active(self) -> None:
        """``active``: the running lanes whose block holds a mask token."""
        self.active.copy_((self.block() == self.mask_id).any(-1)
                          & ~self.done)


def extras_shapes(cfg: ModelConfig, spec: SamplerSpec) -> dict:
    """The request extras a decode of ``cfg`` under ``spec`` takes, each
    key's shape a lane: whisper's frames ``encoder_embeds``
    (encoder_seq_len, d), and, with ``spec.pos_offset``, the prefix
    ``prefix_embeds`` (pos_offset, d)."""
    out = {}
    if cfg.is_encoder_decoder:
        out["encoder_embeds"] = (cfg.encoder_seq_len, cfg.d_model)
    if spec.pos_offset:
        out["prefix_embeds"] = (spec.pos_offset, cfg.d_model)
    return out


def _block_positions(start, B: int, b: int, device) -> torch.Tensor:
    """(b, B) positions of the block at ``start`` (an int or a 0-dim
    device tensor) in every lane."""
    return (start + torch.arange(B, device=device)).expand(b, B)


def lane_block_forward(params, tokens, starts, kv_cache, *, cfg: ModelConfig,
                       spec: SamplerSpec, return_hidden: bool = False,
                       decode_attention_fn=decode_attention,
                       paged_decode_attention_fn=paged_decode_attention,
                       elementwise_fns=ElementwiseFns(),
                       use_long_window: bool = False,
                       moe_per_row: bool):
    """Block-causal cached forward where each lane decodes its own block.

    tokens: (b, T) canvases; starts: (b,) canvas coordinate of each lane's
    active block, which at ``spec.pos_offset`` past it is the block's
    absolute position and the lane's valid cache length; kv_cache: a
    dense ``core.cache.init_cache`` tuple or a ``core.cache.PagedCache``
    (an encoder-decoder's cross attention reads the cache's ``ck``/``cv``).
    Returns ``(logits (b, B, V), emissions)``, or the post-norm hidden
    ``(b, B, d)`` in place of the logits with ``return_hidden`` (the
    lm_head is then skipped).

    The JAX package vmaps a one-lane forward; here the lanes form one batch
    with per-lane positions and cache lengths. ``decode_attention_fn`` and
    ``paged_decode_attention_fn`` (default: the CUDA kernels' wrappers) are
    the attention of every cached forward on a dense and a paged cache;
    ``None`` takes the generic masked attention instead (on a paged cache,
    over the gathered dense view); ``elementwise_fns`` (default the fused
    kernels', None: the plain ops) as in ``forward``. ``use_long_window``
    caps attention at ``cfg.long_context_window``.

    Exactness: under the block-causal mask a lane's output depends only on
    its own cache rows and its own block, so lanes at different block
    offsets share one batch without loss. That holds for MoE slots too:
    ``moe_per_row`` gives each lane its own expert capacity, as the
    reference's one-lane forward has: the continuous engine passes True;
    the static engine's block loop, which the reference runs as one
    batched forward, passes False. Every caller states its choice.
    """
    B, off = spec.block_size, spec.pos_offset
    starts = torch.as_tensor(starts, dtype=torch.int64, device=tokens.device)
    pos = starts[:, None] + torch.arange(B, device=tokens.device)
    out = forward(params, tokens.gather(1, pos), cfg=cfg,
                  device=tokens.device, mode=masks.BLOCK_CAUSAL,
                  prompt_len=spec.full_prompt_len, block_size=B,
                  positions=pos + off, cache=kv_cache,
                  cache_len=starts + off,
                  decode_attention_fn=decode_attention_fn,
                  paged_decode_attention_fn=paged_decode_attention_fn,
                  elementwise_fns=elementwise_fns,
                  use_long_window=use_long_window,
                  return_logits=not return_hidden, moe_per_row=moe_per_row)
    return (out.hidden if return_hidden else out.logits), out.emissions


def _canvas_index(b: int, T: int, V: int, start, B: int, device):
    """The flat counters of a ``(b, T, V)`` draw at the block ``[start,
    start + B)`` of every lane (``start`` an int or a 0-dim device
    tensor): ``(b, B, V)``, int32 where they fit."""
    dt = torch.int32 if b * T * V <= 1 << 31 else torch.int64
    rows = ((torch.arange(b, device=device)[:, None] * T + start
             + torch.arange(B, device=device)) * V).to(dt)
    return rows[..., None] + torch.arange(V, dtype=dt, device=device)


def _canvas_draw(logits, tokens, start, T: int, temperature: float,
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
              prefill_fn=flash_block_attention, extras=None):
    """One step of the top-1 loop before its selection: a bidirectional
    forward over the whole canvases ``tokens`` (b, P+G), then the
    candidates, their confidences and the post-norm hidden states of the
    block at canvas coordinate ``start``, each (b, B[, d]). With
    ``spec.fused_select`` the forward runs through ``prefill_fn`` (the
    block attention kernel); otherwise through the generic attention, as
    the JAX collector does. ``w`` (default the model's): the (V, d)
    unembedding; ``extras`` the request extras. Selection as
    :func:`_top1_pick`. Call it under ``torch.no_grad()``."""
    hidden = _canvas_hidden(params, tokens, cfg=cfg, spec=spec,
                            prefill_fn=(prefill_fn if spec.fused_select
                                        else None), extras=extras)
    return _top1_pick(hidden, tokens, start, cfg=cfg, spec=spec,
                      w=unembed_matrix(params, cfg) if w is None else w,
                      key=key)


def _canvas_hidden(params, tokens, *, cfg: ModelConfig, spec: SamplerSpec,
                   prefill_fn=flash_block_attention, elementwise_fns=None,
                   extras=None):
    """The top-1 step's forward: post-norm hidden states (b, P+G, d) of
    the whole canvases (after ``extras``' prefix, whose rows are dropped),
    bidirectional, through ``prefill_fn`` (the block attention kernel;
    None: the generic attention) and ``elementwise_fns`` (None: the plain
    ops)."""
    return forward(params, tokens, cfg=cfg, device=tokens.device,
                   mode=masks.BIDIRECTIONAL, prompt_len=spec.full_prompt_len,
                   block_size=spec.block_size, return_logits=False,
                   prefill_attention_fn=prefill_fn,
                   elementwise_fns=elementwise_fns,
                   **(extras or {})).hidden[:, spec.pos_offset:]


def _top1_pick(hidden, tokens, start: int, *, cfg: ModelConfig,
               spec: SamplerSpec, w, key=None):
    """The top-1 step's selection from the canvas' hidden states: the
    block's candidates and confidences, and its hidden states. A sampled
    step (``spec.temperature > 0`` and ``key``) draws from the block's
    logits (the lm_head by ``w``) as the reference draws over the canvas;
    a greedy one selects through the fused select kernel
    (``spec.fused_select``) or the argmax of the block's logits."""
    B = spec.block_size
    hidden = hidden[:, start:start + B]
    bt = tokens[:, start:start + B]
    if spec.temperature > 0 and key is not None:
        logits = D.dense_logits(hidden, w, cfg.final_logit_softcap)
        cand, conf = _canvas_draw(logits, bt, start, tokens.shape[1],
                                  spec.temperature, key, cfg)
    elif spec.fused_select:
        cand, conf = D.confidence_and_candidates_fused(
            hidden, w, bt, cfg.mask_token_id,
            softcap=cfg.final_logit_softcap)
    else:
        cand, conf = D.confidence_and_candidates(
            D.dense_logits(hidden, w, cfg.final_logit_softcap), bt,
            cfg.mask_token_id)
    return cand, conf, hidden


def _loaded(state: Optional[DecodeState], prompt_tokens, *,
            cfg: ModelConfig, spec: SamplerSpec, strategy: DecodeStrategy,
            key, lanes: Optional[LaneParams] = None,
            extras: Optional[dict] = None) -> DecodeState:
    """``state`` (a fresh one when None) loaded with the decode of
    ``prompt_tokens`` and its ``extras``."""
    if state is None:
        state = DecodeState(cfg, spec, strategy, prompt_tokens.shape[0],
                            prompt_tokens.device, dtype=prompt_tokens.dtype)
    state.load(prompt_tokens, key, lanes, extras)
    return state


def _top1_loop(params, prompt_tokens, *, cfg: ModelConfig, spec: SamplerSpec,
               record_hidden: bool, key=None, graphs: Optional[bool] = None,
               fns: AttentionFns = KERNELS,
               state: Optional[DecodeState] = None, replay=None,
               extras: Optional[dict] = None):
    """N = G steps, one most-confident token finalized per step, each step a
    bidirectional forward over the whole canvas (the ``vanilla`` strategy,
    :func:`top1_step`). Runs under ``torch.no_grad()``. ``key`` (default
    ``PRNGKey(0)``) is split once per step, as in the reference; a sampled
    step (``spec.temperature > 0``) draws with the second half.

    With ``record_hidden`` also returns ``finalized_at`` (b, G) int32, the
    step at which each position was finalized (the monotone trajectory's
    exact encoding), and the fp32 hidden buffer (b, G, d): the teacher's
    last hidden state at each position's finalization.

    The canvas forward (``extras`` with it: whisper's encoder runs in
    every step, as in the reference) goes through ``replay`` (the step
    ``"canvas"``; the selection after it runs eagerly); ``state`` and
    ``replay`` as in :func:`run_block_loop`. Without ``replay``,
    ``graphs``: None (the default) runs the fused step's forward as a CUDA
    graph captured once per call (its warm-up run serving as the first
    step's forward) on CUDA with ``spec.fused_select``, and eagerly
    otherwise; False runs it eagerly; True where it cannot apply raises.
    """
    graphable = spec.fused_select and prompt_tokens.device.type == "cuda"
    if graphs and not graphable:
        raise ValueError("graphs=True needs spec.fused_select and a CUDA "
                         "device")
    if replay is None:
        replay = (GR.Graphs() if graphable and graphs is not False
                  else GR.eager)
    sampled = spec.temperature > 0
    dev = prompt_tokens.device
    key = prng.key(0, dev) if key is None else key.to(dev)
    with torch.no_grad():
        st = _loaded(state, prompt_tokens, cfg=cfg, spec=spec,
                     strategy=STRATEGIES["vanilla"], key=key, extras=extras)
        tokens = st.tokens
        b = tokens.shape[0]
        P, B, G = spec.prompt_len, spec.block_size, spec.gen_len
        finalized_at = torch.full((b, G), -1, dtype=torch.int32, device=dev)
        hidden_buf = torch.zeros((b, G, cfg.d_model), dtype=torch.float32,
                                 device=dev)
        w = unembed_matrix(params, cfg)
        whole_block = torch.ones((1, B), dtype=torch.bool, device=dev)
        prefill_fn = fns.prefill if spec.fused_select else None

        def canvas():
            # the canvas is written in place below: a graph reads it at
            # its fixed address
            return _canvas_hidden(params, tokens, cfg=cfg, spec=spec,
                                  prefill_fn=prefill_fn,
                                  elementwise_fns=fns.elementwise,
                                  extras=st.extras)

        step = 0
        for blk in range(spec.n_blocks):
            start = P + blk * B
            for _ in range(B):
                sub = None
                if sampled:      # a greedy step never reads its subkey
                    key, sub = prng.split(key)
                cand, conf, hidden = _top1_pick(
                    replay("canvas", canvas), tokens, start, cfg=cfg,
                    spec=spec, w=w, key=sub)
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
def _finalize(tokens, pos, cand, conf, tau, active) -> None:
    """The threshold rule in block coordinates: the active lanes' positions
    ``pos`` (b, B) whose confidence reaches ``tau`` (scalar or (b, 1)), and
    always the most confident masked one, take their candidates; written
    into ``tokens`` in place."""
    bt = tokens.gather(1, pos)
    whole = torch.ones((1, pos.shape[1]), dtype=torch.bool,
                       device=tokens.device)
    sel = D.select_threshold_in_block(conf, whole, tau) & active[:, None]
    tokens.scatter_(1, pos, torch.where(sel, cand.to(bt.dtype), bt))


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


def _variant(spec: SamplerSpec, lane_params, lane_sampled: bool) -> str:
    """The threshold iteration's variant, as the reference specializes its
    sampler: the scalar path ``"greedy"`` (fused or dense logits, by
    ``spec.fused_select``) or ``"sampled"`` (the canvas-shaped draw), the
    per-lane path ``"lanes"`` (greedy; fused by ``spec.fused_select``) or
    ``"lanes-sampled"``."""
    if lane_params is not None:
        return "lanes-sampled" if lane_sampled else "lanes"
    return "sampled" if spec.temperature > 0 else "greedy"


def _threshold_iteration(params, st: DecodeState, *, cfg: ModelConfig,
                         spec: SamplerSpec, strategy: DecodeStrategy,
                         fns: AttentionFns, variant: str,
                         use_long_window: bool = False) -> None:
    """One refinement iteration of the active lanes on ``st`` alone (the
    static engine captures it as a CUDA graph per variant): the key split
    (every iteration of the scalar stream; each active lane's key on the
    per-lane path), the block forward, the selection, the threshold rule,
    the scatter into the canvases, ``steps += active`` and the next
    iteration's ``active``. ``use_long_window`` caps the cached forwards'
    attention at ``cfg.long_context_window``."""
    per_lane = variant.startswith("lanes")
    if per_lane:
        keys, sub = D.split_lane_keys(st.lanes.key, st.active)
        st.lanes.key.copy_(keys)
    else:
        pairs = prng.split(st.key)
        st.key.copy_(pairs[0])
        sub = pairs[1]
    fused = spec.fused_select and variant in ("greedy", "lanes")
    net, _ = _block_forward(params, st.tokens, st.start, st.cache, cfg=cfg,
                            spec=spec, strategy=strategy, fns=fns,
                            return_hidden=fused, astart=st.astart,
                            extras=st.extras,
                            use_long_window=use_long_window)
    pos = st.positions()
    bt = st.tokens.gather(1, pos)
    if per_lane:
        cand, conf = _block_candidates_per_lane(
            params, cfg, spec, net, bt, st.lanes, sub, fused=fused,
            sampled=variant == "lanes-sampled")
        tau = st.lanes.conf_threshold[:, None]
    elif variant == "greedy":
        cand, conf = _block_candidates(params, cfg, spec, net, bt, sub)
        tau = spec.conf_threshold
    else:
        cand, conf = _canvas_draw(net, bt, st.start, st.tokens.shape[1],
                                  spec.temperature, sub, cfg)
        tau = spec.conf_threshold
    _finalize(st.tokens, pos, cand, conf, tau, st.active)
    st.steps += st.active.to(torch.int32)
    st.refresh_active()


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
                   spec: SamplerSpec, fns: AttentionFns,
                   extras: Optional[dict] = None) -> None:
    """The approx policies' refresh: a bidirectional forward over the whole
    canvases (after ``extras``' prefix; whisper's encoder runs here)
    through ``fns.prefill``, every row's KV committed at offset 0 (in
    place), and a recurrent state (and the cross attention's ``ck``/
    ``cv``) replaced by the state after the whole canvas, its stale future
    blocks included, as the reference's refresh does. Only the emissions
    are read, so the lm_head is skipped."""
    out = forward(params, tokens, cfg=cfg, device=tokens.device,
                  mode=masks.BIDIRECTIONAL, prompt_len=spec.full_prompt_len,
                  block_size=spec.block_size, return_logits=False,
                  prefill_attention_fn=fns.prefill,
                  elementwise_fns=fns.elementwise, **(extras or {}))
    C.commit(kv_cache, out.emissions, 0)


def _block_pos_mask(T: int, start, size: int, device) -> torch.Tensor:
    pos = torch.arange(T, device=device)
    return (pos >= start) & (pos < start + size)


def _block_forward(params, tokens, start, kv_cache, *,
                   cfg: ModelConfig, spec: SamplerSpec,
                   strategy: DecodeStrategy, fns: AttentionFns,
                   return_hidden: bool, astart=None,
                   extras: Optional[dict] = None,
                   use_long_window: bool = False):
    """The forward of one threshold iteration for the block at canvas
    coordinate ``start`` (an int, or a 0-dim int64 tensor on the device:
    then no host read; ``astart``, default ``start + spec.pos_offset``,
    its absolute position) under ``strategy.cache_policy``: ``(the
    block's post-norm hidden (b, B, d) with return_hidden, else its
    logits (b, B, V); emissions)``. ``none``: the whole canvases (after
    ``extras``' prefix, whisper's encoder run again) through
    ``fns.prefill``, the lm_head over the block only; the approx
    policies: the block against the stale cache with the block's own rows
    invalid (``cache_valid``, the generic attention); ``exact-commit``:
    the block against the exact cache through the layout's decode
    attention. The cached forwards take no extras (the cache holds the
    cross attention's K/V and the prefix's rows) and attend within
    ``cfg.long_context_window`` when ``use_long_window``, as the
    reference's block forward does."""
    policy, B, dev = strategy.cache_policy, spec.block_size, tokens.device
    b, T = tokens.shape
    start = torch.as_tensor(start, dtype=torch.int64, device=dev)
    if policy == "exact-commit":
        # one batched forward, as the reference's block loop runs it: the
        # lanes' tokens share the MoE slots' expert capacity
        return lane_block_forward(params, tokens, start.expand(b), kv_cache,
                                  cfg=cfg, spec=spec,
                                  return_hidden=return_hidden,
                                  decode_attention_fn=fns.decode,
                                  paged_decode_attention_fn=fns.paged_decode,
                                  elementwise_fns=fns.elementwise,
                                  use_long_window=use_long_window,
                                  moe_per_row=False)
    pos = _block_positions(start, B, b, dev)
    if policy == "none":
        out = forward(params, tokens, cfg=cfg, device=dev,
                      mode=strategy.attn_mode,
                      prompt_len=spec.full_prompt_len, block_size=B,
                      prefill_attention_fn=fns.prefill, return_logits=False,
                      elementwise_fns=fns.elementwise, **(extras or {}))
        hidden = out.hidden.gather(
            1, (pos + spec.pos_offset)[..., None].expand(
                b, B, out.hidden.shape[-1]))
        if return_hidden:
            return hidden, out.emissions
        return (D.dense_logits(hidden, unembed_matrix(params, cfg),
                               cfg.final_logit_softcap), out.emissions)
    if astart is None:
        astart = start + spec.pos_offset
    out = forward(params, tokens.gather(1, pos), cfg=cfg, device=dev,
                  mode=strategy.attn_mode, prompt_len=spec.full_prompt_len,
                  block_size=B, positions=astart + torch.arange(B, device=dev),
                  cache=kv_cache, cache_len=astart,
                  cache_valid=~_block_pos_mask(T + spec.pos_offset, astart,
                                               B, dev),
                  use_long_window=use_long_window,
                  elementwise_fns=fns.elementwise,
                  return_logits=not return_hidden)
    return out.hidden if return_hidden else out.logits, out.emissions


def _threshold_loop(params, st: DecodeState, *, cfg: ModelConfig,
                    spec: SamplerSpec, strategy: DecodeStrategy,
                    variant: str, fns: AttentionFns = KERNELS,
                    replay=GR.eager,
                    use_long_window: bool = False) -> SampleResult:
    """The threshold loop on the loaded state ``st``: per block the
    refinement iterations (:func:`_threshold_iteration`, of the
    ``variant`` :func:`_variant` names) while a running lane holds a mask token in the
    block and fewer than B ran. One host read per iteration (the
    reference's ``while_loop`` condition). The forward of an iteration, by
    ``strategy.cache_policy``:

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

    Every step goes through ``replay``: the iteration (named by its
    variant), ``"prefill"``, ``"refresh"`` and the commit pass's forward
    ``"commit"``. The cache writes at host offsets (the exact prefill's
    and the commit pass's, :func:`_commit_any`) and the block's start and
    first ``active`` run eagerly between them.

    With request extras (``st.extras``) the full-sequence forwards (the
    prefill, the refreshes, ``none``'s canvas) take them and the cached
    block forwards read the cache, as in the reference: whisper's encoder
    runs in each full-sequence forward, whose commit writes the cross
    attention's ``ck``/``cv``; internvl2's prefix rows lie before the
    canvas, every block at ``start + spec.pos_offset``. ``use_long_window``
    applies to the cached block forwards only (the reference's)."""
    policy = strategy.cache_policy
    P, B, R = spec.prompt_len, spec.block_size, spec.cache_refresh_interval
    off = spec.pos_offset
    b = st.tokens.shape[0]
    per_lane = variant.startswith("lanes")

    def refresh():
        _refresh_cache(params, st.tokens, st.cache, cfg=cfg, spec=spec,
                       fns=fns, extras=st.extras)

    def prompt_emissions():
        return forward(params, st.tokens[:, :P], cfg=cfg,
                       device=st.tokens.device, mode=strategy.attn_mode,
                       prompt_len=spec.full_prompt_len, block_size=B,
                       return_logits=False, prefill_attention_fn=fns.prefill,
                       elementwise_fns=fns.elementwise,
                       **st.extras).emissions

    def iteration():
        _threshold_iteration(params, st, cfg=cfg, spec=spec,
                             strategy=strategy, fns=fns, variant=variant,
                             use_long_window=use_long_window)

    def commit_emissions():
        return _block_forward(params, st.tokens, st.start, st.cache, cfg=cfg,
                              spec=spec, strategy=strategy, fns=fns,
                              return_hidden=True, astart=st.astart,
                              use_long_window=use_long_window)[1]

    with torch.no_grad():
        calls = 0
        if policy == "exact-commit":
            _commit_any(st.cache, replay("prefill", prompt_emissions), 0, b)
            calls = 1
        elif policy != "none":
            replay("refresh", refresh)
            calls = 1

        for blk in range(spec.n_blocks):
            start = P + blk * B
            st.start.fill_(start)
            st.astart.fill_(start + off)
            if policy == "approx-dual" and blk > 0:
                replay("refresh", refresh)
                calls += 1
            st.refresh_active()
            for it in range(B):
                if not bool(st.active.any()):
                    break
                if policy == "approx-interval" and it % R == R - 1:
                    replay("refresh", refresh)
                replay(variant, iteration)
                calls += 1
            if policy == "exact-commit":
                # commit pass: recompute the finalized block's KV exactly
                _commit_any(st.cache, replay("commit", commit_emissions),
                            start + off, b)
                calls += 1
            if spec.early_stop:
                eos = st.lanes.eos_id[:, None] if per_lane \
                    else cfg.eos_token_id
                st.done |= (st.block() == eos).any(-1)
    return SampleResult(st.tokens, st.steps, calls,
                        _gen_lengths(st.tokens, spec, cfg,
                                     eos_id=(st.lanes.eos_id if per_lane
                                             else None)))


# ---------------------------------------------------------------------------
# Finalization family: greedy-next (the AR baseline)
# ---------------------------------------------------------------------------
def _ar_prefill(params, st: DecodeState, *, cfg: ModelConfig,
                spec: SamplerSpec, strategy: DecodeStrategy,
                fns: AttentionFns) -> None:
    """The AR prefill: the prompts (after ``st.extras``' prefix; whisper's
    encoder runs here) under ``strategy.attn_mode`` through
    ``fns.prefill``, committed at 0, the logits of the last row into
    ``st.last``."""
    P = spec.full_prompt_len
    out = forward(params, st.tokens[:, :spec.prompt_len], cfg=cfg,
                  device=st.tokens.device, mode=strategy.attn_mode,
                  prefill_attention_fn=fns.prefill, logits_slice=(P - 1, P),
                  elementwise_fns=fns.elementwise,
                  **st.extras)
    C.commit(st.cache, out.emissions, 0)
    st.last.copy_(out.logits[:, -1])


def _ar_step(params, st: DecodeState, *, cfg: ModelConfig,
             strategy: DecodeStrategy, fns: AttentionFns,
             off: int = 0) -> None:
    """One AR step at the canvas position ``st.pos``, on ``st`` alone (the
    static engine captures it as one CUDA graph and replays it G times):
    the argmax of ``st.last`` (EOS once a lane is done) into the canvas,
    ``steps`` and ``done``, the cached forward of that token at the
    absolute position ``st.pos + off`` through ``fns.decode``, its KV
    committed there and its recurrent state in place of the old
    (``core.cache.commit_at``), its logits into ``st.last``, and
    ``st.pos`` advanced."""
    tokens, b = st.tokens, st.tokens.shape[0]
    eos = torch.full((b,), cfg.eos_token_id, dtype=tokens.dtype,
                     device=tokens.device)
    nxt = torch.where(st.done, eos, torch.argmax(st.last, -1).to(
        tokens.dtype))
    tokens.scatter_(1, st.pos.expand(b, 1), nxt[:, None])
    st.steps += (~st.done).to(torch.int32)
    st.done |= nxt == eos
    apos = st.pos + off
    out = forward(params, nxt[:, None], cfg=cfg, device=tokens.device,
                  mode=strategy.attn_mode, cache=st.cache, cache_len=apos,
                  decode_attention_fn=fns.decode,
                  elementwise_fns=fns.elementwise)
    C.commit_at(st.cache, out.emissions, apos)
    st.last.copy_(out.logits[:, -1])
    st.pos += 1


def _greedy_next_loop(params, st: DecodeState, *, cfg: ModelConfig,
                      spec: SamplerSpec, strategy: DecodeStrategy,
                      fns: AttentionFns = KERNELS,
                      replay=GR.eager) -> SampleResult:
    """Autoregressive greedy decode with a KV cache on the loaded state
    ``st``: the prompt prefilled under ``strategy.attn_mode`` (causal)
    through ``fns.prefill`` and committed, the logits of its last row only
    (:func:`_ar_prefill`, the step ``"prefill"``); then ``gen_len`` steps
    (:func:`_ar_step`, the step ``"step"``), each the argmax of the last
    logits (first occurrence; EOS once a lane is done), one cached forward
    of that token through ``fns.decode`` and its KV committed. ``steps``
    counts a lane's steps before its EOS, ``calls`` is ``1 + gen_len``
    (the reference's ``fori_loop``, which also runs the last step's
    forward); ``spec.early_stop`` changes nothing, as in the reference. No
    host read."""
    with torch.no_grad():
        replay("prefill", lambda: _ar_prefill(params, st, cfg=cfg, spec=spec,
                                              strategy=strategy, fns=fns))
        st.pos.fill_(spec.prompt_len)
        for _ in range(spec.gen_len):
            replay("step", lambda: _ar_step(params, st, cfg=cfg,
                                            strategy=strategy, fns=fns,
                                            off=spec.pos_offset))
    return SampleResult(st.tokens, st.steps, 1 + spec.gen_len,
                        _gen_lengths(st.tokens, spec, cfg))


def run_block_loop(params, prompt_tokens, *, cfg: ModelConfig,
                   spec: SamplerSpec, strategy: DecodeStrategy, key=None,
                   record_hidden: bool = False,
                   lane_params: Optional[LaneParams] = None,
                   lane_sampled: bool = False,
                   graphs: Optional[bool] = None,
                   attention_fns: AttentionFns = KERNELS,
                   state: Optional[DecodeState] = None, replay=None,
                   extras: Optional[dict] = None,
                   use_long_window: bool = False):
    """Decode ``prompt_tokens`` (b, P) with ``strategy`` over the block
    grid; returns :class:`SampleResult`, with ``record_hidden`` (top-1
    only) also the trajectory encoding ``(finalized_at, hidden)``.

    ``key`` (default ``PRNGKey(0)``) is the scalar path's stream;
    ``lane_params`` switches the threshold loop to per-lane params, with
    ``lane_sampled`` set when some lane draws. ``graphs`` is the top-1
    loop's (:func:`_top1_loop`). ``attention_fns`` is the attention of
    every forward (:class:`AttentionFns`; default the CUDA kernels',
    :data:`PLAIN` the plain versions). A strategy whose (cache policy,
    finalize rule) pair is none of :data:`STRATEGIES`' raises.

    ``state``: a :class:`DecodeState` for ``strategy`` and ``spec`` to
    decode in, loaded here (default: a fresh one); the result's tokens and
    steps are then its buffers, which its next decode rewrites.
    ``replay``: the hook every step goes through (``repro_torch.graphs``;
    default :func:`repro_torch.graphs.eager`, and the top-1 loop's own).

    ``extras``: the request extras ``(b, ...)`` a config takes
    (:func:`extras_shapes`: whisper's ``encoder_embeds``, and with
    ``spec.pos_offset`` internvl2's ``prefix_embeds``), loaded into the
    state. ``use_long_window`` caps the threshold loop's cached block
    forwards at ``cfg.long_context_window``, as in the reference."""
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
                          graphs=graphs, fns=attention_fns, state=state,
                          replay=replay, extras=extras)
    replay = GR.eager if replay is None else replay
    with torch.no_grad():
        st = _loaded(state, prompt_tokens, cfg=cfg, spec=spec,
                     strategy=strategy, key=key, lanes=lane_params,
                     extras=extras)
    if strategy.finalize == "threshold":
        return _threshold_loop(params, st, cfg=cfg, spec=spec,
                               strategy=strategy,
                               variant=_variant(spec, lane_params,
                                                lane_sampled),
                               fns=attention_fns, replay=replay,
                               use_long_window=use_long_window)
    return _greedy_next_loop(params, st, cfg=cfg, spec=spec,
                             strategy=strategy, fns=attention_fns,
                             replay=replay)
