"""Continuous block-level batching engine, ported from the JAX package's
``serving/engine.py`` for the configuration the port serves: the ``cdlm``
strategy, the dense or block-paged KV layout, greedy decoding through the
fused unembed + select kernel (``ServeConfig.fused_select=True``; the
dense-logits decode path is not ported yet).

A persistent batch of ``max_batch`` lanes advances one *block* per
``step()``, each lane at its own block offset
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
call, and an admission one call.

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

On CUDA the block decode replays CUDA graphs (``repro_torch.graphs``), the
port's counterpart of the JAX engine's ``jax.jit``: one refinement
iteration (the cached forward, the fused select, the threshold rule, the
scatter into the canvas and the next iteration's ``active`` mask) and the
commit pass's forward, each captured once per engine at :meth:`warmup`
(or at the first :meth:`step`). The engine's device state (canvases, the
dense cache or the paged pools, the device page table and the per-lane
``starts``, ``live``, ``taus`` and ``active`` vectors) is allocated once
per engine and written in place, so the graphs read it at fixed
addresses. The host loop and its stop rule stay as they are: one read of
``active`` per iteration, so tokens, steps, call counts and page
statistics are the eager path's. ``graphs=False`` keeps the eager path on
CUDA, for A/B runs and tests; the CPU runs eagerly.
"""
from __future__ import annotations

import bisect
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import graphs as GR
from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, ServeConfig
from repro_torch.core import cache as C
from repro_torch.core import diffusion as D
from repro_torch.core import masks
from repro_torch.core.block_loop import (
    SamplerSpec,
    _gen_lengths,
    init_canvas,
    lane_block_forward,
)
from repro_torch.kernels.block_attn import flash_block_attention
from repro_torch.models import forward, unembed_matrix
from repro_torch.models.transformer import check_dense
from repro_torch.serving.api import (
    BlockEvent,
    GenerationOutput,
    GenerationRequest,
    ResolvedSamplingParams,
    SamplingParams,
    normalize_requests,
)


def _resolve(req: GenerationRequest, serve: ServeConfig,
             cfg: ModelConfig) -> ResolvedSamplingParams:
    params = req.params if req.params is not None else SamplingParams()
    return params.resolve(serve, cfg, request_id=req.id,
                          legacy_max_tokens=req.max_tokens)


def _validate_params(req: GenerationRequest, serve: ServeConfig) -> None:
    """Per-request params constraints, checked at ``add_request`` time so
    a bad request fails its own submission instead of the shared decode
    step. The port decodes greedily only: ``temperature > 0`` is refused
    (the JAX engine refuses it under ``fused_select``)."""
    if req.params is None or req.params.is_engine_default:
        return
    if (req.params.temperature or 0) > 0:
        raise ValueError(
            "repro_torch serves greedy requests only (per-request "
            "temperature > 0 needs sampled decoding, not ported yet)")


def _finish_reason(gen: np.ndarray, glen_raw: int,
                   rp: ResolvedSamplingParams) -> str:
    """"stop" when the request's EOS token landed within its budget."""
    if not np.any(gen == rp.eos_token_id):
        return "length"
    if rp.max_tokens is not None and glen_raw > rp.max_tokens:
        return "length"
    return "stop"


class _RequestStepper:
    """Request-level surface: id/param validation at enqueue time, and the
    ``stream()``/``generate()`` drains over the engine's ``step()``."""

    def _register(self, request: GenerationRequest, taken) -> None:
        _validate_params(request, self.serve)
        self._next_id = normalize_requests([request], self._next_id,
                                           taken=taken)
        if len(np.asarray(request.prompt)) != self.spec.prompt_len:
            raise ValueError(
                f"prompt length {len(np.asarray(request.prompt))} != engine "
                f"prompt_len {self.spec.prompt_len}")

    def stream(self, requests: Sequence[GenerationRequest]):
        """Drain ``requests`` through the stepper, yielding a
        :class:`BlockEvent` the moment each block commits."""
        if not requests:
            return
        if self.has_unfinished():
            raise RuntimeError("engine busy: drain or abort in-flight "
                               "requests before a fresh stream()/generate()")
        self._reset()
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

    def generate(self, requests: Sequence[GenerationRequest]
                 ) -> List[GenerationOutput]:
        """The final outputs, in completion order."""
        return [ev.output for ev in self.stream(requests) if ev.finished]


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
        for t in (self.starts_t, self.live_t, self.taus_t, self.active_t):
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
    (dense or paged layout, greedy). ``device`` defaults to the CUDA
    device; pass ``device="cpu"`` to run on the CPU (the kernels' plain
    versions). ``graphs``: None (the default) decodes through CUDA graphs
    on CUDA and eagerly on the CPU; False decodes eagerly on CUDA too;
    True on the CPU raises."""

    def __init__(self, params, cfg: ModelConfig, serve: ServeConfig,
                 prompt_len: int, *, device="cuda", graphs=None):
        if serve.sampler != "cdlm":
            raise ValueError(
                "ContinuousEngine requires the 'cdlm' strategy (exact "
                f"block-causal cache); got sampler={serve.sampler!r}")
        if serve.cache_layout not in C.CACHE_LAYOUTS:
            raise ValueError(f"unknown cache layout {serve.cache_layout!r} "
                             f"(expected one of {C.CACHE_LAYOUTS})")
        if (serve.cache_layout != C.PAGED
                and serve.page_pool_pages is not None):
            raise ValueError("page_pool_pages requires cache_layout='paged' "
                             "— the dense layout preallocates per-lane "
                             "buffers and would silently ignore the budget")
        if serve.temperature > 0:
            raise ValueError("repro_torch serves greedy decoding only: the "
                             "engine default temperature must be 0")
        if not serve.fused_select:
            raise ValueError("repro_torch decodes through the fused select "
                             "kernel only: set ServeConfig(fused_select=True)")
        check_dense(cfg)
        self.device = resolve_device(device)
        if graphs and self.device.type != "cuda":
            raise ValueError(f"graphs=True needs a CUDA device, the engine "
                             f"runs on {self.device}")
        self.graphed = self.device.type == "cuda" and graphs is not False
        self._graphs = None        # (refine, commit), captured at warmup
        if params["embed"]["tok"].device != self.device:
            raise ValueError(f"params live on {params['embed']['tok'].device}"
                             f", the engine runs on {self.device}")
        self.params = params
        self.cfg = cfg
        self.serve = serve
        self.spec = SamplerSpec(
            prompt_len=prompt_len, gen_len=serve.gen_length,
            block_size=serve.block_size, conf_threshold=serve.conf_threshold)
        self.n_lanes = serve.max_batch
        self.paged = serve.cache_layout == C.PAGED
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

    def _admit(self, state: _Slots, prompts, admit, nblocks, taus, eos):
        """Write the admitted lanes' canvases, reset their cache rows (paged:
        allocate prompt + first-block pages), prefill the prompts under the
        block-causal mask through the block attention kernel and commit them
        into those rows (the prefill runs every lane, as the JAX engine's
        does, and commits only the admitted ones)."""
        spec = self.spec
        canvas = init_canvas(torch.as_tensor(prompts, dtype=torch.int64,
                                             device=self.device), spec,
                             self.cfg)
        rows = torch.as_tensor(admit, device=self.device)
        state.tokens.copy_(torch.where(rows[:, None], canvas, state.tokens))
        C.reset(state.cache, admit)
        if self.paged:
            _, ok = C.alloc(state.cache, admit, 0,
                            spec.prompt_len + spec.block_size)
            if not ok[admit].all():
                raise RuntimeError("admission outside the free-page budget: "
                                   "scheduler invariant violated")
        out = forward(self.params, state.tokens[:, :spec.prompt_len],
                      cfg=self.cfg, device=self.device,
                      mode=masks.BLOCK_CAUSAL, prompt_len=spec.prompt_len,
                      block_size=spec.block_size, return_logits=False,
                      prefill_attention_fn=flash_block_attention)
        C.commit_rows(state.cache, out.emissions, 0, admit)
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

    def _refine(self) -> None:
        """One refinement iteration of the active lanes, on the device
        state alone (captured as a CUDA graph): the cached forward of each
        lane's block, the fused select, the threshold rule and the scatter
        of the selected candidates into the canvases, then the next
        iteration's ``active``."""
        state, cfg = self._state, self.cfg
        pos = self._block_positions(state)
        bt = state.tokens.gather(1, pos)
        hidden, _ = lane_block_forward(
            self.params, state.tokens, state.starts_t, state.cache, cfg=cfg,
            spec=self.spec, return_hidden=True)
        cand, conf = D.confidence_and_candidates_fused(
            hidden, unembed_matrix(self.params, cfg), bt, cfg.mask_token_id,
            softcap=cfg.final_logit_softcap)
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
            cfg=self.cfg, spec=self.spec, return_hidden=True)
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

    def _capture(self, state: _Slots, starts, live) -> tuple:
        """Capture the refinement iteration and the commit forward, sharing
        one memory pool. The refinement's warm-up run changes the canvases:
        the caller clears the state after."""
        self._write_block_inputs(state, starts, live)
        pool = torch.cuda.graph_pool_handle()
        return (GR.Graph(self._refine, pool=pool),
                GR.Graph(self._commit_forward, pool=pool))

    def _decode_block(self, state: _Slots, run) -> None:
        """Advance the lanes in ``run`` by one block: threshold refinement
        to completion, then the exact commit pass into each lane's rows."""
        spec, dev = self.spec, self.device
        P, B = spec.prompt_len, spec.block_size
        live = state.live & run
        starts = P + np.clip(state.blk, 0, spec.n_blocks - 1) * B
        self._write_block_inputs(state, starts, live)
        refine, commit = ((self._refine, self._commit_forward)
                          if self._graphs is None
                          else (g.replay for g in self._graphs))
        it = 0
        while it < B:
            # the loop condition is read back to the host: one device sync
            # per refinement iteration (a copy: on the CPU, .cpu() aliases
            # the buffer the iteration rewrites)
            active = state.active_t.cpu().numpy().copy()
            if not active.any():
                break
            refine()
            state.steps += active
            state.calls["refine"] += 1
            it += 1

        # commit pass: recompute the finalized blocks' KV exactly, for the
        # lanes that ran, each at its own offset
        C.commit_rows(state.cache, commit(), starts, live)
        state.calls["commit"] += 1

        bt = state.tokens.gather(1, self._block_positions(state))
        eos_hit = (bt == torch.as_tensor(state.eos, device=dev)[:, None]
                   ).any(-1).cpu().numpy()
        state.blk = np.where(live, state.blk + 1, state.blk)
        finished = live & (eos_hit | (state.blk >= state.lane_nblocks))
        state.live &= ~finished

    # -- host-side scheduler -------------------------------------------------
    def _reset(self) -> None:
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
        self._pool_samples: List[int] = []
        self._live_samples: List[int] = []
        self._preemptions = 0
        self._stall_rounds = 0

    def warmup(self) -> None:
        """Build and load the kernels, capture the decode's CUDA graphs
        (once per engine), and run one admission and one block decode on
        the engine's state, which is cleared after. Refused while a request
        is in flight."""
        if any(f is not None for f in self._flights):
            raise RuntimeError("engine busy: warmup() needs every lane free")
        state = self._state
        N, P = self.n_lanes, self.spec.prompt_len
        lanes = np.ones((N,), bool)
        if self.paged:     # as many lanes as the pool admits at once
            lanes[self.n_pages // self._admit_pages:] = False
        self._admit(state, np.zeros((N, P), np.int64), lanes,
                    state.lane_nblocks, state.taus, state.eos)
        if self.graphed and self._graphs is None:
            self._graphs = self._capture(state, np.full((N,), P, np.int64),
                                         lanes)
        self._decode_block(state, lanes)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        state.clear()

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
            raise ValueError("repro_torch's ContinuousEngine does not take "
                             "request extras")
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
        request's :class:`GenerationOutput`)."""
        N, P, B = self.n_lanes, self.spec.prompt_len, self.spec.block_size
        if self.graphed and self._graphs is None:
            self.warmup()      # no step has run yet: every lane is free
        state = self._state
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
        taus = np.zeros((N,), np.float32)
        eos = np.zeros((N,), np.int64)
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
            taus[lane] = rp.conf_threshold
            eos[lane] = rp.eos_token_id
            if self.paged:
                budget -= self._admit_pages
        if admit.any():
            self._admit(state, prompts, admit, nblocks, taus, eos)
            run = run | admit
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
            self._pool_samples.append(self.n_pages
                                      - C.free_page_count(state.cache))

        # ---- one block-level decode for the runnable lanes ----
        self._live_samples.append(int(run.sum()))
        self._decode_block(state, run)
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
        if not self.paged or not self._pool_samples:
            return {"n_pages": float(self.n_pages), "peak_pages": 0.0,
                    "avg_pages": 0.0, "peak_occupancy": 0.0,
                    "preemptions": 0.0, "stall_rounds": 0.0}
        peak = max(self._pool_samples)
        return {
            "n_pages": float(self.n_pages),
            "peak_pages": float(peak),
            "avg_pages": float(np.mean(self._pool_samples)),
            "peak_occupancy": peak / self.n_pages,
            "preemptions": float(self._preemptions),
            "stall_rounds": float(self._stall_rounds),
        }

    def concurrency_stats(self) -> Dict[str, float]:
        """Decoding-lane concurrency since the last reset, sampled at every
        block-level decode step."""
        if not self._live_samples:
            return {"peak_lanes": 0.0, "avg_lanes": 0.0}
        return {"peak_lanes": float(max(self._live_samples)),
                "avg_lanes": float(np.mean(self._live_samples))}


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
