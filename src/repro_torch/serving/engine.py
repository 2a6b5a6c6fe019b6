"""Batched serving engines, ported from the JAX package's
``serving/engine.py``. Both expose the request-level incremental API of
``serving/api.py`` (``add_request``, ``step``, ``abort``,
``has_unfinished``, ``stream``, ``generate``), and both serve per-request
sampling params: greedy and sampled lanes mix, each sampled lane drawing
from its own stream ``PRNGKey(seed)`` (:mod:`repro_torch.prng`, the
reference's threefry), advanced only on its own active iterations, so its
tokens are the JAX engine's and do not depend on its batch.

- :class:`Engine`, **static batching**: up to ``max_batch`` queued
  requests are padded into one batch and decoded to completion by the
  sampler (``core/sampler.py``: any of the six decoders); a batch without
  explicit params takes the engine's scalar path and key chain
  (``PRNGKey(0)`` by default, split once per batch), one with them the
  per-lane path. ``step()`` emits the batch's block events at once.

- :class:`ContinuousEngine`, **continuous block-level batching** over the
  ``cdlm`` strategy, on the dense or the block-paged KV layout.

The continuous engine keeps a persistent batch of ``max_batch`` lanes and
advances it one *block* per ``step()``, each lane at its own block offset
(:func:`repro_torch.core.block_loop.lane_block_forward`). At every block
boundary finished lanes are evicted, their cache rows reset, and queued
requests admitted into the freed lanes (prompt prefill committed into
their rows). Block-causal cache exactness makes lane recycling loss-free:
a request admitted mid-flight decodes exactly as it does alone.

The refinement loop of a block follows the JAX engine's ``while_loop``
rule exactly, so ``steps`` and the call count agree with it: iterate while
any running lane still has a mask token in its block and fewer than
``block_size`` iterations ran; each iteration is one call and adds 1 to
the steps of every lane that was active; the commit pass is one more
call, and an admission one call. An iteration takes one of three
variants, as the JAX engine's two ``jit`` specialisations and its
``fused_select`` switch do: fused greedy (``ServeConfig.fused_select``:
the fused unembed + select kernel, no logits), dense-logits greedy, and
sampled (some lane in flight has ``temperature > 0``: every active lane's
key is split, greedy lanes take the argmax of the logits, sampled lanes
draw). A ``fused_select`` engine serves greedy requests only, as the
reference's does.

Prompt prefill at admission goes through the block attention kernel
(``kernels.block_attn``); cached forwards through the dense or the paged
decode attention kernel, by layout.

Paged layout (``ServeConfig(cache_layout="paged", page_pool_pages=N)``):
KV lives in a pool of ``N`` pages of ``block_size`` tokens shared by the
lanes (``core.cache.PagedCache``), and ``step`` follows the JAX engine's
order exactly, so that stalls and preemptions match it: the in-flight
lanes' current blocks are backed first (when none can be, the youngest
lane is preempted and its request requeued at the front), admission is
budgeted by free pages (prompt + first block per request), the survivors'
next blocks are claimed right after the decode, and finished lanes'
pages are freed at once. The allocator lives on the host, so no
allocation result is ever read off the device.

On CUDA the continuous engine's block decode replays CUDA graphs
(``repro_torch.graphs``), the port's counterpart of the JAX engine's
``jax.jit``: each iteration variant (the cached forward, the selection,
the threshold rule, the scatter into the canvas, the next iteration's
``active`` mask, and for the sampled variant the key split) and the commit
pass's forward, each captured once per engine at :meth:`warmup` or on
first use (the capture's warm-up run is then that iteration). The
engine's device state (canvases, the dense cache or the paged pools, the
device page table and the per-lane ``starts``, ``live``, ``taus``,
``temps``, ``keys`` and ``active`` vectors) is allocated once per engine
and written in place, so the graphs read it at fixed addresses. The host
loop and its stop rule stay as they are: one read of ``active`` per
iteration, so tokens, steps, call counts and page statistics are the
eager path's.

The static engine's decode replays CUDA graphs too, the counterpart of
the JAX engine's ``jax.jit`` of its sampler: the batch shape is fixed
(``max_batch`` lanes, ``prompt_len``), so the decode's device state
(``core.block_loop.DecodeState``: canvases, cache, keys, the per-lane
vectors and params, the block's start and the AR step's position as
device tensors) is allocated once per engine and each batch is loaded
into it in place. Every step of the sampler's loop is captured once per
engine, at :meth:`Engine.warmup` or on first use, into one memory pool:
the threshold iteration of each variant the engine meets (scalar greedy
or sampled, per-lane greedy or sampled), the prompt prefill, the approx
policies' refresh and the commit pass's forward; the AR step; and
``vanilla``'s canvas forward. The host loop stays the sampler's (one read
of ``active`` per threshold iteration), so tokens, steps and calls are
the eager path's.

``graphs=False`` keeps either engine eager on CUDA, for A/B runs and
tests; the CPU runs eagerly.
"""
from __future__ import annotations

import bisect
import functools
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import graphs as GR
from repro_torch import prng, resolve_device
from repro_torch.configs.base import ModelConfig, ServeConfig, check_supported
from repro_torch.core import cache as C
from repro_torch.core import diffusion as D
from repro_torch.core import masks
from repro_torch.core.block_loop import (
    STRATEGIES,
    DecodeState,
    LaneParams,
    SamplerSpec,
    _gen_lengths,
    extras_shapes,
    init_canvas,
    lane_block_forward,
    run_block_loop,
)
from repro_torch.core.sampler import SAMPLERS
from repro_torch.kernels.block_attn import flash_block_attention
from repro_torch.kernels.elementwise import ElementwiseFns
from repro_torch.kernels.moe import grouped_experts
from repro_torch.models import forward, unembed_matrix
from repro_torch.serving.api import (
    BlockEvent,
    GenerationOutput,
    GenerationRequest,
    ResolvedSamplingParams,
    SamplingParams,
    normalize_requests,
)
from repro_torch.spans import Phases


def _validate_requests(requests: Sequence[GenerationRequest]) -> None:
    """Every request of a batch carries the same extras keys (the
    reference's check, made before the batch leaves the queue)."""
    keys0 = frozenset(requests[0].extras or {})
    for r in requests:
        if frozenset(r.extras or {}) != keys0:
            raise ValueError(
                "all requests in a batch must carry the same extras keys: "
                f"request {requests[0].id} has {sorted(keys0)}, request "
                f"{r.id} has {sorted(r.extras or {})}")


# the continuous engine's phases (``ContinuousEngine.phase_stats``)
PHASES = ("engine.step", "engine.schedule", "engine.admit", "engine.block",
          "engine.sync", "engine.refine", "engine.commit", "engine.finish")

EXTRAS_REFUSED = ("ContinuousEngine does not support request extras "
                  "(encoder/prefix embeds) yet")


def _resolve(req: GenerationRequest, serve: ServeConfig,
             cfg: ModelConfig) -> ResolvedSamplingParams:
    params = req.params if req.params is not None else SamplingParams()
    return params.resolve(serve, cfg, request_id=req.id,
                          legacy_max_tokens=req.max_tokens)


def _validate_params(req: GenerationRequest, serve: ServeConfig) -> None:
    """Per-request params constraints, checked at ``add_request`` time so
    a bad request fails its own submission (HTTP 400) instead of the
    shared decode step: non-threshold samplers have no per-lane selection
    loop, and ``fused_select`` engines are greedy-only (a sampled lane
    would move its greedy batch-mates from the fused kernel to the dense
    selection, whose last-ulp confidence differences could break
    isolated-decode exactness)."""
    if req.params is None or req.params.is_engine_default:
        return
    if STRATEGIES[serve.sampler].finalize != "threshold":
        raise ValueError(
            "per-request SamplingParams require a threshold-finalize "
            f"sampler; {serve.sampler!r} uses "
            f"{STRATEGIES[serve.sampler].finalize!r} (set the knobs "
            "globally in ServeConfig instead)")
    if serve.fused_select and (req.params.temperature or 0) > 0:
        raise ValueError(
            "fused_select engines serve greedy requests only "
            "(per-request temperature > 0 would mix fused and dense "
            "selection paths within one batch); disable fused_select to "
            "serve sampled requests")


def _lane_key(rp: ResolvedSamplingParams) -> np.ndarray:
    """A request's stream root, ``PRNGKey(seed)`` as (2,) int64 uint32
    values: scheduler- and batch-invariant, so isolated and batched
    decodes draw alike."""
    return prng.key(rp.seed).numpy()


def _finish_reason(gen: np.ndarray, glen_raw: int,
                   rp: ResolvedSamplingParams) -> str:
    """"stop" when the request's EOS token landed within its budget."""
    if not np.any(gen == rp.eos_token_id):
        return "length"
    if rp.max_tokens is not None and glen_raw > rp.max_tokens:
        return "length"
    return "stop"


class _RequestStepper:
    """Request-level surface: id/param validation at enqueue time, the
    ``stream()``/``generate()`` drains over the engine's ``step()``, and
    the decode's replay hook over the engine's ``_graphs``."""

    def _register(self, request: GenerationRequest, taken) -> None:
        _validate_params(request, self.serve)
        self._next_id = normalize_requests([request], self._next_id,
                                           taken=taken)
        if len(np.asarray(request.prompt)) != self.spec.prompt_len:
            raise ValueError(
                f"prompt length {len(np.asarray(request.prompt))} != engine "
                f"prompt_len {self.spec.prompt_len}")

    def stream(self, requests: Sequence[GenerationRequest], key=None):
        """Drain ``requests`` through the stepper, yielding a
        :class:`BlockEvent` the moment each block commits. ``key`` roots
        the static engine's scalar stream (the continuous engine's lanes
        draw from their requests' seeds)."""
        if not requests:
            return
        if self.has_unfinished():
            raise RuntimeError("engine busy: drain or abort in-flight "
                               "requests before a fresh stream()/generate()")
        self._reset(key)
        ids = [self.add_request(r) for r in requests]
        try:
            while self.has_unfinished():
                yield from self.step()
        finally:
            # early exit: drop this call's leftovers so the engine is not
            # left busy (abort of completed ids is a no-op)
            if self.has_unfinished():
                for rid in ids:
                    self.abort(rid)

    def generate(self, requests: Sequence[GenerationRequest], key=None
                 ) -> List[GenerationOutput]:
        """The final outputs, in completion order."""
        return [ev.output for ev in self.stream(requests, key=key)
                if ev.finished]

    def _replay(self, name: str, fn):
        """The decode's replay hook: ``fn()`` through the engine's CUDA
        graph ``name`` (captured now, the capture's warm-up run being this
        call, if new), or eagerly when the engine has no graphs."""
        return fn() if self._graphs is None else self._graphs(name, fn)


class _Tally:
    """Count, sum and peak of a sampled whole number, kept running."""
    __slots__ = ("n", "total", "peak")

    def __init__(self):
        self.n = self.total = self.peak = 0

    def add(self, x: int) -> None:
        self.n += 1
        self.total += x
        self.peak = max(self.peak, x)


class _Flight:
    """Host record of one in-flight request; ``arrival`` is its effective
    arrival offset (trace ``arrival_s`` or the ``add_request`` time)."""
    __slots__ = ("req", "rp", "admit_t", "arrival", "blocks_done")

    def __init__(self, req: GenerationRequest, rp: ResolvedSamplingParams,
                 admit_t: float, arrival: float):
        self.req = req
        self.rp = rp
        self.admit_t = admit_t
        self.arrival = arrival
        self.blocks_done = 0


def _check_params_device(params, device: torch.device) -> None:
    if params["embed"]["tok"].device != device:
        raise ValueError(f"params live on {params['embed']['tok'].device}"
                         f", the engine runs on {device}")


def _check_graphs(graphs, device: torch.device) -> bool:
    """Whether an engine on ``device`` decodes through CUDA graphs:
    ``graphs`` None on CUDA or True; True off CUDA raises."""
    if graphs and device.type != "cuda":
        raise ValueError(f"graphs=True needs a CUDA device, the engine "
                         f"runs on {device}")
    return device.type == "cuda" and graphs is not False


class Engine(_RequestStepper):
    """Static fixed-shape batching over any of the six samplers
    (``core/sampler.py``). ``step()`` pops up to ``max_batch`` queued
    requests, pads them into one batch, decodes it to completion and emits
    every block event of the batch at once. The decode runs through
    ``run_block_loop`` on the engine's :class:`DecodeState`: full-sequence
    forwards (prompt prefill, full-canvas recompute, cache refresh)
    through the block attention kernel, exact-cache and AR forwards
    through the decode attention kernel, and, with ``fused_select``,
    greedy threshold and top-1 selection through the select kernel.
    ``device`` defaults to the CUDA device; pass ``device="cpu"`` to run
    on the CPU (the kernels' plain versions). ``graphs``: None (the
    default) replays each step of the decode as a CUDA graph on CUDA
    (captured once per engine) and runs eagerly on the CPU; False runs
    eagerly on CUDA too; True on the CPU raises.

    Requests carry the extras their config takes
    (``core.block_loop.extras_shapes``): whisper's ``encoder_embeds``
    (encoder_seq_len, d), internvl2's ``prefix_embeds`` (pos_offset, d)
    with ``pos_offset`` the number of prefix rows; a batch's extras are
    stacked (padded with the last request's) into the state's buffers.
    ``use_long_window`` caps the cached forwards at
    ``cfg.long_context_window`` as the reference's engine does: on the
    scalar path for ``cdlm`` only, on the per-lane path for every
    threshold sampler."""

    def __init__(self, params, cfg: ModelConfig, serve: ServeConfig,
                 prompt_len: int, *, pos_offset: int = 0,
                 use_long_window: bool = False, device="cuda", graphs=None):
        if serve.sampler not in SAMPLERS:
            raise ValueError(f"unknown sampler {serve.sampler!r} (expected "
                             f"one of {', '.join(SAMPLERS)})")
        if serve.page_pool_pages is not None:
            raise ValueError(
                "page_pool_pages is only honored by the continuous "
                "scheduler with the paged layout; the static engine runs "
                "whole sequences to completion, so its paged pool is "
                "always sized dense-equivalent (batch x full canvas)")
        check_supported(cfg)
        self.device = resolve_device(device)
        self.graphed = _check_graphs(graphs, self.device)
        _check_params_device(params, self.device)
        self.params = params
        self.cfg = cfg
        self.serve = serve
        self.spec = SamplerSpec(
            prompt_len=prompt_len, gen_len=serve.gen_length,
            block_size=serve.block_size, conf_threshold=serve.conf_threshold,
            temperature=serve.temperature,
            cache_refresh_interval=serve.cache_refresh_interval,
            cache_layout=serve.cache_layout, fused_select=serve.fused_select,
            pos_offset=pos_offset)
        self._use_long_window = use_long_window
        self._strategy = STRATEGIES[serve.sampler]
        # the decode's device buffers, loaded in place by every batch, and
        # the graphs of its steps by name (captured at first use)
        self._state = DecodeState(cfg, self.spec, self._strategy,
                                  serve.max_batch, self.device)
        self._graphs = GR.Graphs() if self.graphed else None
        self._next_id = 0
        self._reset()

    # -- incremental core ---------------------------------------------------
    def _reset(self, key=None) -> None:
        self._key = (prng.key(0, self.device) if key is None
                     else torch.as_tensor(key, dtype=torch.int64,
                                          device=self.device))
        self._queue: List[GenerationRequest] = []
        self._calls = {"batches": 0, "total": 0}

    def call_counts(self) -> Dict[str, int]:
        """Batches decoded and forward passes (prefills, refinement
        iterations and commit passes: the samplers' ``n_model_calls``)
        since the last reset."""
        return dict(self._calls)

    def add_request(self, request: GenerationRequest) -> int:
        """Enqueue one request; returns its (possibly engine-assigned) id."""
        self._register(request, {r.id for r in self._queue})
        self._queue.append(request)
        return request.id

    def has_unfinished(self) -> bool:
        return bool(self._queue)

    def abort(self, request_id: int) -> bool:
        """Drop a queued request (a batch runs synchronously, so nothing is
        in flight between ``step()`` calls)."""
        for i, r in enumerate(self._queue):
            if r.id == request_id:
                del self._queue[i]
                return True
        return False

    def _run(self, prompts, key=None, lanes: Optional[LaneParams] = None,
             sampled: bool = False, extras: Optional[dict] = None):
        """One batch through the sampler's strategy on the engine's state
        and graphs: the scalar path with ``key``, or per-lane params
        ``lanes`` (``sampled``: some lane draws), with the batch's
        ``extras``. The result's tokens and steps are the state's buffers,
        rewritten by the next batch. The long window as the reference's
        two runners pass it: the scalar one for ``cdlm`` only."""
        window = self._use_long_window and (lanes is not None
                                            or self.serve.sampler == "cdlm")
        return run_block_loop(self.params, prompts, cfg=self.cfg,
                              spec=self.spec, strategy=self._strategy,
                              key=key, lane_params=lanes,
                              lane_sampled=sampled, state=self._state,
                              replay=self._replay, extras=extras,
                              use_long_window=window)

    def _lanes(self, rps: Sequence[ResolvedSamplingParams]) -> LaneParams:
        dev = self.device
        return LaneParams(
            temperature=torch.tensor([p.temperature for p in rps],
                                     dtype=torch.float32, device=dev),
            conf_threshold=torch.tensor([p.conf_threshold for p in rps],
                                        dtype=torch.float32, device=dev),
            eos_id=torch.tensor([p.eos_token_id for p in rps],
                                dtype=torch.int64, device=dev),
            key=torch.as_tensor(np.stack([_lane_key(p) for p in rps]),
                                device=dev))

    def warmup(self, extras=None, *, per_request: bool = False) -> None:
        """Build and load the kernels, and capture the decode's CUDA graphs
        (once per engine), on one batch of the scalar path (with
        ``extras``, a batch's, or zeros of the config's extras);
        ``per_request=True`` (servers) also runs the per-lane variants (the
        sampled one unless ``fused_select``)."""
        b = self.serve.max_batch
        prompts = torch.zeros((b, self.spec.prompt_len), dtype=torch.int64,
                              device=self.device)
        if extras is None:
            extras = {k: torch.zeros((b, *shape), device=self.device)
                      for k, shape in extras_shapes(self.cfg,
                                                    self.spec).items()}
        self._run(prompts, extras=extras)
        if per_request and self._strategy.finalize == "threshold":
            rp = ResolvedSamplingParams(0.0, self.serve.conf_threshold, None,
                                        0, self.cfg.eos_token_id)
            lanes = self._lanes([rp] * b)
            self._run(prompts, lanes=lanes, extras=extras)
            if not self.serve.fused_select:
                self._run(prompts, lanes=lanes, sampled=True, extras=extras)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _n_emit_blocks(self, gen: np.ndarray,
                       rp: ResolvedSamplingParams) -> int:
        """Blocks to stream: through the first block holding the request's
        EOS, else up to its ``max_tokens`` cap (rounded up to a block),
        else the whole grid."""
        B = self.spec.block_size
        cap = self.spec.n_blocks
        if rp.max_tokens is not None:
            cap = max(1, min(cap, -(-rp.max_tokens // B)))
        hits = np.flatnonzero(gen == rp.eos_token_id)
        if hits.size:
            return min(int(hits[0]) // B + 1, cap)
        return cap

    def step(self) -> List[BlockEvent]:
        """Run one batch of up to ``max_batch`` queued requests to
        completion; returns every block event of the batch (final events
        carry the :class:`GenerationOutput`)."""
        if not self._queue:
            return []
        Bmax = self.serve.max_batch
        chunk = self._queue[:Bmax]
        _validate_requests(chunk)   # before the chunk leaves the queue
        del self._queue[:Bmax]
        rps = [_resolve(r, self.serve, self.cfg) for r in chunk]
        pad = Bmax - len(chunk)
        prompts = torch.as_tensor(
            np.stack([np.asarray(r.prompt) for r in chunk]
                     + [np.asarray(chunk[-1].prompt)] * pad),
            dtype=torch.int64, device=self.device)
        extras = {k: torch.as_tensor(np.stack(
            [np.asarray(r.extras[k]) for r in chunk]
            + [np.asarray(chunk[-1].extras[k])] * pad), device=self.device)
            for k in (chunk[0].extras or {})}
        self._key, sub = prng.split(self._key)
        # a batch is one decode, so any request with explicit params moves
        # the whole batch to the per-lane path (its bare batch-mates then
        # draw from their own streams, as in the reference)
        use_lanes = any(r.params is not None
                        and not r.params.is_engine_default for r in chunk)
        t0 = time.perf_counter()
        if use_lanes:
            prps = rps + [rps[-1]] * pad
            res = self._run(prompts, lanes=self._lanes(prps),
                            sampled=any(p.temperature > 0 for p in prps),
                            extras=extras)
        else:
            res = self._run(prompts, sub, extras=extras)
        self._calls["batches"] += 1
        self._calls["total"] += res.n_model_calls
        # copies: the result is the engine's state, which the next batch
        # rewrites (on the CPU, .cpu() aliases it)
        toks = res.tokens.cpu().numpy().copy()
        steps = res.steps.cpu().numpy().copy()
        glens = res.gen_lengths.cpu().numpy()
        dt = (time.perf_counter() - t0) / len(chunk)
        P, B = self.spec.prompt_len, self.spec.block_size
        events: List[BlockEvent] = []
        for j, (r, rp) in enumerate(zip(chunk, rps)):
            gen = toks[j, P:]
            glen_raw = int(glens[j])
            # the reason is judged on the untrimmed span (the continuous
            # engine's rule: EOS landing exactly on the cap is "stop")
            reason = _finish_reason(gen, glen_raw, rp)
            glen = glen_raw
            if rp.max_tokens is not None:
                glen = min(glen, rp.max_tokens)
                gen = gen[:rp.max_tokens]
            out = GenerationOutput(
                id=r.id, tokens=gen, gen_length=glen, steps=int(steps[j]),
                latency_s=dt, finish_reason=reason)
            n_blocks = self._n_emit_blocks(gen, rp)
            for blk in range(n_blocks):
                events.append(BlockEvent(
                    request_id=r.id, index=blk, start=blk * B,
                    tokens=toks[j, P + blk * B:P + (blk + 1) * B].copy(),
                    finished=(blk == n_blocks - 1),
                    output=out if blk == n_blocks - 1 else None))
        return events


class _Slots:
    """Decode state of the lane batch: canvases, KV cache and the block
    loop's per-lane vectors on the device, allocated once and written in
    place (a CUDA graph reads them at fixed addresses); per-lane
    bookkeeping on the host (the host loop reads it every iteration
    anyway)."""

    def __init__(self, tokens, cache, n_blocks: int, tau: float, eos: int,
                 mask_id: int):
        N = tokens.shape[0]
        dev = tokens.device
        self.tokens = tokens                       # (N, P+G) on the device
        self.cache = cache                         # dense tuple or paged
        self.mask_id = mask_id
        self.defaults = (n_blocks, tau, eos)
        # the current block's inputs and the refinement loop's mask
        self.starts_t = torch.zeros((N,), dtype=torch.int64, device=dev)
        self.live_t = torch.zeros((N,), dtype=torch.bool, device=dev)
        self.taus_t = torch.zeros((N, 1), dtype=torch.float32, device=dev)
        self.active_t = torch.zeros((N,), dtype=torch.bool, device=dev)
        # per-lane sampling state, written at admission; the sampled
        # iteration advances the keys in place
        self.temps_t = torch.zeros((N,), dtype=torch.float32, device=dev)
        self.keys_t = torch.zeros((N, 2), dtype=torch.int64, device=dev)
        self.clear()

    def clear(self) -> None:
        """Empty every lane, in place: mask-token canvases, a zeroed cache
        (paged: every page back in the pool) and host records."""
        N = self.tokens.shape[0]
        n_blocks, tau, eos = self.defaults
        self.tokens.fill_(self.mask_id)
        if isinstance(self.cache, C.PagedCache):
            C.free(self.cache, np.ones((N,), bool))
            bufs = [b for slot in self.cache.slots for b in slot.values()]
        else:
            bufs = [b for slot in self.cache for b in slot.values()]
        for buf in bufs:
            buf.zero_()
        for t in (self.starts_t, self.live_t, self.taus_t, self.active_t,
                  self.temps_t, self.keys_t):
            t.zero_()
        self.blk = np.zeros((N,), np.int64)        # current block per lane
        self.lane_nblocks = np.full((N,), n_blocks, np.int64)
        self.live = np.zeros((N,), bool)           # occupied and unfinished
        self.steps = np.zeros((N,), np.int64)      # refinement iterations
        self.taus = np.full((N,), tau, np.float32)
        self.eos = np.full((N,), eos, np.int64)
        self.calls = {"admit": 0, "refine": 0, "commit": 0}


class ContinuousEngine(_RequestStepper):
    """Slot-based continuous batching over the CDLM exact-cache strategy
    (dense or paged layout; greedy and sampled lanes, per request).
    ``device`` defaults to the CUDA device; pass ``device="cpu"`` to run on
    the CPU (the kernels' plain versions). ``graphs``: None (the default)
    decodes through CUDA graphs on CUDA and eagerly on the CPU; False
    decodes eagerly on CUDA too; True on the CPU raises.
    ``use_long_window`` caps the lanes' cached forwards at
    ``cfg.long_context_window`` (the admission prefill keeps the full
    span, as the reference's). It refuses an encoder-decoder and request
    extras, as the reference's does."""

    def __init__(self, params, cfg: ModelConfig, serve: ServeConfig,
                 prompt_len: int, *, use_long_window: bool = False,
                 device="cuda", graphs=None):
        if serve.sampler != "cdlm":
            raise ValueError(
                "ContinuousEngine requires the 'cdlm' strategy (exact "
                f"block-causal cache); got sampler={serve.sampler!r}")
        if cfg.is_encoder_decoder:
            raise ValueError("ContinuousEngine does not support "
                             "encoder-decoder models yet (per-lane encoder "
                             "state is not scheduled)")
        if serve.cache_layout not in C.CACHE_LAYOUTS:
            raise ValueError(f"unknown cache layout {serve.cache_layout!r} "
                             f"(expected one of {C.CACHE_LAYOUTS})")
        if (serve.cache_layout != C.PAGED
                and serve.page_pool_pages is not None):
            raise ValueError("page_pool_pages requires cache_layout='paged' "
                             "— the dense layout preallocates per-lane "
                             "buffers and would silently ignore the budget")
        if serve.fused_select and serve.temperature > 0:
            raise ValueError(
                "fused_select is greedy-only: a sampled default "
                "(temperature > 0) would route every step through the "
                "dense selection path, mixing fused and dense decodes "
                "across batch compositions")
        check_supported(cfg)
        self.device = resolve_device(device)
        self.graphed = _check_graphs(graphs, self.device)
        # the captured graphs by name: the iteration variants ("fused",
        # "dense", "sampled") and "commit"
        self._graphs = GR.Graphs() if self.graphed else None
        _check_params_device(params, self.device)
        self.params = params
        self.cfg = cfg
        self.serve = serve
        self.spec = SamplerSpec(
            prompt_len=prompt_len, gen_len=serve.gen_length,
            block_size=serve.block_size, conf_threshold=serve.conf_threshold,
            temperature=serve.temperature, cache_layout=serve.cache_layout,
            fused_select=serve.fused_select)
        # the greedy iteration: the fused select kernel from the hidden
        # states, or the argmax of dense logits
        self._greedy = "fused" if serve.fused_select else "dense"
        self.n_lanes = serve.max_batch
        self.paged = serve.cache_layout == C.PAGED
        self._use_long_window = use_long_window
        P, B = prompt_len, serve.block_size
        if self.paged:
            self._n_tables = -(-(P + serve.gen_length) // B)
            self.n_pages = (serve.page_pool_pages
                            if serve.page_pool_pages is not None
                            else self.n_lanes * self._n_tables)
            if self.n_pages < self._n_tables:
                raise ValueError(
                    f"page pool of {self.n_pages} pages cannot back one "
                    f"full request ({self._n_tables} pages of {B} tokens "
                    f"for prompt {P} + gen {serve.gen_length}) — this is "
                    "the deadlock-free minimum")
            # pages a fresh request needs at admission: prompt + first block
            self._admit_pages = C.pages_for_span(0, P + B, B)
        else:
            self.n_pages = 0
        self._next_id = 0
        self._state = self._init_state()
        self._arange_b = torch.arange(B, device=self.device)
        self._all_block = torch.ones((1, B), dtype=torch.bool,
                                     device=self.device)
        self._phases = Phases(PHASES)
        # a "grouped" MoE config's device-side tally, pairs per expert then
        # the rows the expert products computed (padding included): every
        # forward's alignment pass adds into it on the device, inside the
        # graphs; only moe_stats() reads it on the host
        self._moe_tally = (torch.zeros(cfg.n_experts + 1, dtype=torch.int64,
                                       device=self.device)
                           if cfg.moe_dispatch == "grouped" else None)
        self._fns = ElementwiseFns(moe=functools.partial(
            grouped_experts, tally=self._moe_tally))
        self._reset()

    # -- state transitions ---------------------------------------------------
    def _init_state(self) -> _Slots:
        N = self.n_lanes
        T = self.spec.prompt_len + self.spec.gen_len
        tokens = torch.full((N, T), self.cfg.mask_token_id, dtype=torch.int64,
                            device=self.device)
        if self.paged:
            cache = C.init_paged_cache(
                self.cfg, N, self._n_tables * self.spec.block_size,
                n_pages=self.n_pages, page_size=self.spec.block_size,
                device=self.device)
        else:
            cache = C.init_cache(self.cfg, N, T, device=self.device)
        return _Slots(tokens, cache, self.spec.n_blocks,
                      self.spec.conf_threshold, self.cfg.eos_token_id,
                      self.cfg.mask_token_id)

    def _admit(self, state: _Slots, prompts, admit, nblocks, temps, taus,
               eos, keys):
        """Write the admitted lanes' canvases and sampling state (temperature
        and key on the device, tau and EOS on the host), reset their cache
        rows (paged: allocate prompt + first-block pages), prefill the
        prompts under the block-causal mask through the block attention
        kernel and commit them into those rows, layer by layer as the
        prefill makes them (it runs every lane, as the JAX engine's does,
        and commits only the admitted ones), its norms, RoPE and gated activations through the fused
        elementwise passes."""
        spec, dev = self.spec, self.device
        canvas = init_canvas(torch.as_tensor(prompts, dtype=torch.int64,
                                             device=dev), spec, self.cfg)
        rows = torch.as_tensor(admit, device=dev)
        state.tokens.copy_(torch.where(rows[:, None], canvas, state.tokens))
        state.temps_t.copy_(torch.where(
            rows, torch.as_tensor(temps, dtype=torch.float32, device=dev),
            state.temps_t))
        state.keys_t.copy_(torch.where(
            rows[:, None], torch.as_tensor(keys, dtype=torch.int64,
                                           device=dev), state.keys_t))
        C.reset(state.cache, admit)
        if self.paged:
            _, ok = C.alloc(state.cache, admit, 0,
                            spec.prompt_len + spec.block_size)
            if not ok[admit].all():
                raise RuntimeError("admission outside the free-page budget: "
                                   "scheduler invariant violated")
        forward(self.params, state.tokens[:, :spec.prompt_len],
                cfg=self.cfg, device=self.device, mode=masks.BLOCK_CAUSAL,
                prompt_len=spec.prompt_len, block_size=spec.block_size,
                return_logits=False,
                prefill_attention_fn=flash_block_attention,
                elementwise_fns=self._fns,
                emit=C.period_commit(state.cache, 0, admit))
        state.blk[admit] = 0
        state.lane_nblocks[admit] = nblocks[admit]
        state.live |= admit
        state.steps[admit] = 0
        state.taus[admit] = taus[admit]
        state.eos[admit] = eos[admit]
        state.calls["admit"] += 1

    def _evict(self, state: _Slots, rows) -> None:
        """Release lanes: mark them dead and reset their cache rows (paged:
        return their pages to the pool)."""
        C.reset(state.cache, rows)
        state.live &= ~rows

    def _alloc_block(self, state: _Slots) -> np.ndarray:
        """Paged: back every live lane's current block with pages. Returns
        the per-lane ok mask; a live lane without ok stalls this round (its
        table is untouched: all-or-nothing per lane)."""
        P, B = self.spec.prompt_len, self.spec.block_size
        starts = P + np.clip(state.blk, 0, self.spec.n_blocks - 1) * B
        _, ok = C.alloc(state.cache, state.live, starts, starts + B)
        return ok

    def _block_positions(self, state: _Slots) -> torch.Tensor:
        """(N, B) canvas positions of each lane's current block."""
        return state.starts_t[:, None] + self._arange_b

    def _refresh_active(self, state: _Slots) -> None:
        """``active``: the live lanes whose block still holds a mask
        token."""
        bt = state.tokens.gather(1, self._block_positions(state))
        state.active_t.copy_((bt == self.cfg.mask_token_id).any(-1)
                             & state.live_t)

    def _refine(self, variant: Optional[str] = None) -> None:
        """One refinement iteration of the active lanes, on the device
        state alone (captured as a CUDA graph per variant): the cached
        forward of each lane's block, the selection, the threshold rule and
        the scatter of the selected candidates into the canvases, then the
        next iteration's ``active``. ``variant`` (default the engine's
        greedy one): "fused" selects through the fused select kernel from
        the hidden states, "dense" takes the argmax of the logits,
        "sampled" first splits every active lane's key and then draws for
        the lanes at temperature > 0 (the argmax for the others)."""
        variant = variant or self._greedy
        state, cfg = self._state, self.cfg
        pos = self._block_positions(state)
        bt = state.tokens.gather(1, pos)
        if variant == "sampled":
            keys, subs = D.split_lane_keys(state.keys_t, state.active_t)
            state.keys_t.copy_(keys)
        net, _ = lane_block_forward(
            self.params, state.tokens, state.starts_t, state.cache, cfg=cfg,
            spec=self.spec, return_hidden=variant == "fused",
            elementwise_fns=self._fns, use_long_window=self._use_long_window,
            moe_per_row=True)
        if variant == "fused":
            cand, conf = D.confidence_and_candidates_fused(
                net, unembed_matrix(self.params, cfg), bt, cfg.mask_token_id,
                softcap=cfg.final_logit_softcap)
        elif variant == "sampled":
            cand, conf = D.confidence_and_candidates_per_lane(
                net, bt, cfg.mask_token_id, state.temps_t, subs)
        else:
            cand, conf = D.confidence_and_candidates(net, bt,
                                                     cfg.mask_token_id)
        sel = D.select_threshold_in_block(conf, self._all_block,
                                          state.taus_t)
        sel = sel & state.active_t[:, None]
        state.tokens.scatter_(1, pos, torch.where(sel, cand.to(bt.dtype),
                                                  bt))
        self._refresh_active(state)

    def _commit_forward(self) -> tuple:
        """The commit pass's forward (captured as a CUDA graph): the
        finalized blocks' KV emissions, each lane at its own offset."""
        state = self._state
        _, emissions = lane_block_forward(
            self.params, state.tokens, state.starts_t, state.cache,
            cfg=self.cfg, spec=self.spec, return_hidden=True,
            elementwise_fns=self._fns, use_long_window=self._use_long_window,
            moe_per_row=True)
        return emissions

    def _write_block_inputs(self, state: _Slots, starts, live) -> None:
        """The block's inputs into the static device buffers, before its
        first iteration: ``starts``, ``live``, ``taus``, the device page
        table, and ``active``."""
        state.starts_t.copy_(torch.from_numpy(starts))
        state.live_t.copy_(torch.from_numpy(live))
        state.taus_t.copy_(torch.from_numpy(state.taus)[:, None])
        if self.paged:
            state.cache.device_table()
        self._refresh_active(state)

    def _decode_block(self, state: _Slots, run,
                      variant: Optional[str] = None) -> None:
        """Advance the lanes in ``run`` by one block: threshold refinement
        to completion, then the exact commit pass into each lane's rows.
        The iteration variant is "sampled" while a request in flight has
        temperature > 0 (the reference's ``_sampled_step``), the engine's
        greedy one otherwise; ``variant`` forces one (warmup)."""
        spec, dev = self.spec, self.device
        P, B = spec.prompt_len, spec.block_size
        variant = variant or ("sampled" if self._sampled_step()
                              else self._greedy)
        live = state.live & run
        starts = P + np.clip(state.blk, 0, spec.n_blocks - 1) * B
        self._write_block_inputs(state, starts, live)
        phases = self._phases
        it = 0
        while it < B:
            # the loop condition is read back to the host: one device sync
            # per refinement iteration (a copy: on the CPU, .cpu() aliases
            # the buffer the iteration rewrites)
            with phases("engine.sync"):
                active = state.active_t.cpu().numpy().copy()
            if not active.any():
                break
            with phases("engine.refine"):
                self._replay(variant, lambda: self._refine(variant))
            state.steps += active
            state.calls["refine"] += 1
            it += 1

        with phases("engine.commit"):
            # commit pass: recompute the finalized blocks' KV exactly, for
            # the lanes that ran, each at its own offset
            C.commit_rows(state.cache,
                          self._replay("commit", self._commit_forward),
                          starts, live)
            state.calls["commit"] += 1
            bt = state.tokens.gather(1, self._block_positions(state))
            eos_hit = (bt == torch.as_tensor(state.eos, device=dev)[:, None]
                       ).any(-1).cpu().numpy()
        state.blk = np.where(live, state.blk + 1, state.blk)
        finished = live & (eos_hit | (state.blk >= state.lane_nblocks))
        state.live &= ~finished

    def _sampled_step(self) -> bool:
        return any(f is not None and f.rp.temperature > 0
                   for f in self._flights)

    # -- host-side scheduler -------------------------------------------------
    def _reset(self, key=None) -> None:
        del key  # per-request streams derive from SamplingParams.seed
        self._state.clear()
        self._queue: List[GenerationRequest] = []
        self._flights: List[Optional[_Flight]] = [None] * self.n_lanes
        self._resolved: Dict[int, ResolvedSamplingParams] = {}
        self._arrival: Dict[int, float] = {}
        # blocks already streamed per request id: a preempted request
        # decodes again from scratch (bit-identically), and its re-decoded
        # blocks must not be streamed twice
        self._emitted: Dict[int, int] = {}
        self._t0 = time.perf_counter()
        self._pool_tally = _Tally()     # pages in use at each block decode
        self._lane_tally = _Tally()     # lanes decoding at each block decode
        self._phases.reset()
        if self._moe_tally is not None:
            self._moe_tally.zero_()
        self._preemptions = 0
        self._stall_rounds = 0

    def warmup(self, extras=None, *, per_request: bool = False) -> None:
        """Build and load the kernels and capture the decode's CUDA graphs
        (once per engine): one admission and one block decode of the greedy
        variant on the engine's state, and of the sampled variant too when
        the engine default samples or, ``per_request`` (servers), any
        request may (not on a ``fused_select`` engine); the state is
        cleared after. Refused while a request is in flight, and with
        ``extras``, as in the reference."""
        if extras:
            raise ValueError(EXTRAS_REFUSED)
        if any(f is not None for f in self._flights):
            raise RuntimeError("engine busy: warmup() needs every lane free")
        state = self._state
        N, P = self.n_lanes, self.spec.prompt_len
        lanes = np.ones((N,), bool)
        if self.paged:     # as many lanes as the pool admits at once
            lanes[self.n_pages // self._admit_pages:] = False
        variants = [self._greedy]
        if self.serve.temperature > 0 or (per_request
                                          and not self.serve.fused_select):
            variants.append("sampled")
        for variant in variants:
            self._admit(state, np.zeros((N, P), np.int64), lanes,
                        state.lane_nblocks, np.zeros((N,), np.float32),
                        state.taus, state.eos, np.zeros((N, 2), np.int64))
            self._decode_block(state, lanes, variant)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        state.clear()
        self._phases.reset()

    def _lane_nblocks(self, rp: ResolvedSamplingParams) -> int:
        if rp.max_tokens is None:
            return self.spec.n_blocks
        return max(1, min(self.spec.n_blocks,
                          -(-rp.max_tokens // self.spec.block_size)))

    def call_counts(self) -> Dict[str, int]:
        """Forward passes since the last reset, by kind, and their total
        (the JAX engine's ``calls``)."""
        calls = dict(self._state.calls)
        calls["total"] = sum(calls.values())
        return calls

    def page_accounting(self):
        """(free pages by the owner list, free pages by the device copy of
        the page tables): equal when every owned page sits in exactly one
        table entry and the device copy is current. The second reads the
        device (it synchronizes): for tests and debugging only."""
        if not self.paged:
            return 0, 0
        cache = self._state.cache
        used = int((cache.device_table() != C.FREE).sum())
        return C.free_page_count(cache), cache.n_pages - used

    def add_request(self, request: GenerationRequest) -> int:
        """Enqueue one request (admitted at the next block boundary with a
        free lane and, paged, enough free pages); returns its unique id."""
        if request.extras:
            raise ValueError(EXTRAS_REFUSED)
        self._register(request,
                       {r.id for r in self._queue}
                       | {f.req.id for f in self._flights if f is not None})
        self._resolved[request.id] = _resolve(request, self.serve, self.cfg)
        self._arrival[request.id] = max(request.arrival_s,
                                        time.perf_counter() - self._t0)
        bisect.insort(self._queue, request, key=lambda r: r.arrival_s)
        return request.id

    def has_unfinished(self) -> bool:
        return bool(self._queue) or any(f is not None for f in self._flights)

    def abort(self, request_id: int) -> bool:
        """Drop a queued or in-flight request; an in-flight lane is evicted
        at once (paged: its pages return to the pool) without touching any
        other lane."""
        for i, r in enumerate(self._queue):
            if r.id == request_id:
                del self._queue[i]
                self._resolved.pop(request_id, None)
                self._emitted.pop(request_id, None)
                self._arrival.pop(request_id, None)
                return True
        for lane, fl in enumerate(self._flights):
            if fl is not None and fl.req.id == request_id:
                row = np.zeros((self.n_lanes,), bool)
                row[lane] = True
                self._evict(self._state, row)
                self._flights[lane] = None
                self._resolved.pop(request_id, None)
                self._emitted.pop(request_id, None)
                self._arrival.pop(request_id, None)
                return True
        return False

    def step(self) -> List[BlockEvent]:
        """Advance one block boundary: (paged) back the in-flight lanes'
        current blocks with pages, admit arrived requests into free lanes,
        decode one block for every runnable lane, (paged) claim the
        survivors' next blocks, evict finished lanes. Returns one
        :class:`BlockEvent` per block finalized (final blocks carry the
        request's :class:`GenerationOutput`). Each part is a phase of
        :meth:`phase_stats`."""
        phases, state = self._phases, self._state
        with phases("engine.step"):
            with phases("engine.schedule"):
                run, admission = self._schedule(state)
            if admission is not None:
                with phases("engine.admit"):
                    self._admit(state, *admission)
                run = run | admission[1]
            if all(f is None for f in self._flights):
                # nothing decoding and nothing arrived yet: idle to the next
                # arrival instead of spinning
                if self._queue:
                    wait = self._queue[0].arrival_s - (time.perf_counter()
                                                       - self._t0)
                    if wait > 0:
                        time.sleep(wait)
                return []
            if self.paged:
                self._pool_tally.add(self.n_pages
                                     - C.free_page_count(state.cache))
            self._lane_tally.add(int(run.sum()))
            with phases("engine.block"):
                self._decode_block(state, run)
            with phases("engine.finish"):
                return self._finish(state, run)

    def _schedule(self, state: _Slots):
        """The host's choices at a block boundary: (paged) back the
        in-flight lanes' current blocks, preempting while none can be, and
        pick the arrived requests to admit into free lanes. Returns the
        runnable lanes and ``_admit``'s arguments (None: nobody admitted)."""
        N, P = self.n_lanes, self.spec.prompt_len
        now = time.perf_counter() - self._t0

        # ---- paged: back the in-flight lanes' current blocks first ----
        live = np.asarray([f is not None for f in self._flights])
        run = live.copy()
        if self.paged and live.any():
            run = self._alloc_block(state) & live
            while not run.any():
                # every live lane is page-starved: preempt the youngest (its
                # pages return to the pool, its request re-enters the queue
                # at the front and decodes again, bit-identically)
                victims = [i for i in range(N) if live[i]]
                if len(victims) == 1:
                    raise RuntimeError(
                        "page pool exhausted with a single live lane — "
                        "pool sizing invariant violated")
                victim = max(victims,
                             key=lambda i: (self._flights[i].admit_t, i))
                vrow = np.zeros((N,), bool)
                vrow[victim] = True
                self._evict(state, vrow)
                self._queue.insert(0, self._flights[victim].req)
                self._flights[victim] = None
                self._preemptions += 1
                live[victim] = False
                run = self._alloc_block(state) & live
            if (live & ~run).any():
                self._stall_rounds += 1

        # ---- admission at the block boundary (paged: budgeted by free
        # pages for prompt + first block, not by whole-sequence reservation)
        budget = C.free_page_count(state.cache) if self.paged else 0
        admit = np.zeros((N,), bool)
        prompts = np.zeros((N, P), np.int64)
        nblocks = np.zeros((N,), np.int64)
        temps = np.zeros((N,), np.float32)
        taus = np.zeros((N,), np.float32)
        eos = np.zeros((N,), np.int64)
        keys = np.zeros((N, 2), np.int64)
        for lane in range(N):
            if self._flights[lane] is not None:
                continue
            if not self._queue or self._queue[0].arrival_s > now:
                break
            if self.paged and budget < self._admit_pages:
                break
            req = self._queue.pop(0)
            rp = self._resolved[req.id]
            self._flights[lane] = _Flight(
                req, rp, admit_t=now,
                arrival=self._arrival.get(req.id, req.arrival_s))
            admit[lane] = True
            prompts[lane] = np.asarray(req.prompt)
            nblocks[lane] = self._lane_nblocks(rp)
            temps[lane] = rp.temperature
            taus[lane] = rp.conf_threshold
            eos[lane] = rp.eos_token_id
            keys[lane] = _lane_key(rp)
            if self.paged:
                budget -= self._admit_pages
        if not admit.any():
            return run, None
        return run, (prompts, admit, nblocks, temps, taus, eos, keys)

    def _finish(self, state: _Slots, run) -> List[BlockEvent]:
        """After a block decode: (paged) claim the survivors' next-block
        pages, read the canvases, emit the block events and evict the
        finished lanes."""
        N, P, B = self.n_lanes, self.spec.prompt_len, self.spec.block_size
        if self.paged:
            # claim the survivors' next-block pages now, so that the next
            # boundary's in-flight allocation finds them backed
            self._alloc_block(state)
        live = state.live
        toks = state.tokens.cpu().numpy()
        t_done = time.perf_counter() - self._t0

        # ---- block events + eviction of finished lanes ----
        ran = [i for i in range(N) if run[i] and self._flights[i] is not None]
        done = [i for i in ran if not live[i]]
        glens = None
        if done:
            glens = _gen_lengths(state.tokens, self.spec, self.cfg,
                                 eos_id=torch.as_tensor(
                                     state.eos, device=self.device)
                                 ).cpu().numpy()
        events: List[BlockEvent] = []
        for lane in ran:
            fl = self._flights[lane]
            blk = fl.blocks_done
            fl.blocks_done += 1
            if live[lane] and blk < self._emitted.get(fl.req.id, 0):
                continue  # a preempted request's re-decode: already streamed
            self._emitted[fl.req.id] = blk + 1
            lo, hi = P + blk * B, P + (blk + 1) * B
            ev = BlockEvent(request_id=fl.req.id, index=blk, start=blk * B,
                            tokens=toks[lane, lo:hi].copy(),
                            finished=not live[lane])
            if ev.finished:
                gen = toks[lane, P:].copy()
                glen_raw = int(glens[lane])
                # reason judged on the untrimmed span; the returned span is
                # sliced to the cap
                reason = _finish_reason(gen, glen_raw, fl.rp)
                glen = glen_raw
                if fl.rp.max_tokens is not None:
                    glen = min(glen, fl.rp.max_tokens)
                    gen = gen[:fl.rp.max_tokens]
                ev.output = GenerationOutput(
                    id=fl.req.id, tokens=gen, gen_length=glen,
                    steps=int(state.steps[lane]),
                    latency_s=t_done - fl.arrival,
                    queue_s=fl.admit_t - fl.arrival, finish_reason=reason)
                self._flights[lane] = None
                self._resolved.pop(fl.req.id, None)
                self._emitted.pop(fl.req.id, None)
                self._arrival.pop(fl.req.id, None)
            events.append(ev)
        if done and self.paged:
            # return the finished lanes' pages to the pool now, so that the
            # next admission sees them
            drow = np.zeros((N,), bool)
            drow[done] = True
            self._evict(state, drow)
        return events

    def page_pool_stats(self) -> Dict[str, float]:
        """Occupancy since the last reset (paged layout; zeros for dense),
        sampled at every block boundary, with the preemptions and the
        rounds in which a live lane stalled for pages."""
        pool = self._pool_tally
        if not self.paged or not pool.n:
            return {"n_pages": float(self.n_pages), "peak_pages": 0.0,
                    "avg_pages": 0.0, "peak_occupancy": 0.0,
                    "preemptions": 0.0, "stall_rounds": 0.0}
        return {
            "n_pages": float(self.n_pages),
            "peak_pages": float(pool.peak),
            "avg_pages": pool.total / pool.n,
            "peak_occupancy": pool.peak / self.n_pages,
            "preemptions": float(self._preemptions),
            "stall_rounds": float(self._stall_rounds),
        }

    def concurrency_stats(self) -> Dict[str, float]:
        """Decoding-lane concurrency since the last reset, sampled at every
        block-level decode step."""
        lanes = self._lane_tally
        if not lanes.n:
            return {"peak_lanes": 0.0, "avg_lanes": 0.0}
        return {"peak_lanes": float(lanes.peak),
                "avg_lanes": lanes.total / lanes.n}

    def phase_stats(self) -> Dict[str, Dict[str, float]]:
        """``{phase: {"count", "seconds"}}`` since the last reset, on the
        host's clock, with or without a profiler: ``engine.step`` (a whole
        :meth:`step`) holds ``engine.schedule`` (page backing, preemption,
        the admission choice), ``engine.admit`` (the admission and its
        prompts' prefill), ``engine.block`` (a block decode) and
        ``engine.finish`` (the next block's pages, the canvases' read, the
        events, eviction); ``engine.block`` holds ``engine.sync`` (each
        read of ``active``: the host waits for the device),
        ``engine.refine`` (each iteration's replay) and ``engine.commit``
        (the commit pass and the EOS read). While a profiler records, each
        phase is also a ``record_function`` range of its name."""
        return self._phases.stats()


    def moe_stats(self) -> Dict[str, object]:
        """A "grouped" MoE config's tally since the last reset (empty for
        any other config): ``pairs_total`` (token, choice) pairs routed over
        every layer of every forward, ``rows_padded_total`` the rows the
        expert products computed for them (each expert's group padded to the
        tile), and ``pairs_per_expert``. It reads the device-side tally,
        which waits for the work queued before it: call it between steps,
        as ``/metrics`` does, never inside one."""
        if self._moe_tally is None:
            return {}
        t = self._moe_tally.cpu()
        return {"pairs_total": int(t[:-1].sum()),
                "rows_padded_total": int(t[-1]),
                "pairs_per_expert": t[:-1].tolist()}


def make_engine(params, cfg: ModelConfig, serve: ServeConfig,
                prompt_len: int, **kw):
    """Engine factory switched by ``serve.scheduler`` (``device``,
    ``graphs``, ``use_long_window`` and the static engine's ``pos_offset``
    pass through; the continuous one refuses a prefix, as the
    reference's factory does)."""
    if serve.scheduler == "continuous":
        if kw.pop("pos_offset", 0):
            raise ValueError("ContinuousEngine does not support prefix "
                             "embeds (pos_offset != 0) yet")
        return ContinuousEngine(params, cfg, serve, prompt_len, **kw)
    if serve.scheduler == "static":
        return Engine(params, cfg, serve, prompt_len, **kw)
    raise ValueError(f"unknown scheduler {serve.scheduler!r} "
                     "(expected 'static' or 'continuous')")


def efficiency_report(responses: Sequence[GenerationOutput]
                      ) -> Dict[str, float]:
    """Per-sample averages, the paper's reporting convention (App. A.3)."""
    if not responses:
        return {"latency_s": 0.0, "steps": 0.0, "gen_length": 0.0,
                "tps": 0.0}
    lat = float(np.mean([r.latency_s for r in responses]))
    steps = float(np.mean([r.steps for r in responses]))
    glen = float(np.mean([r.gen_length for r in responses]))
    tps = glen / lat if lat > 0 else float("inf")
    return {"latency_s": lat, "steps": steps, "gen_length": glen, "tps": tps}
