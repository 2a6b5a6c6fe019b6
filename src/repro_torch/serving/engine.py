"""Continuous block-level batching engine, ported from the JAX package's
``serving/engine.py`` for the configuration the port serves: the ``cdlm``
strategy, the dense KV layout, greedy decoding through the fused
unembed + select kernel (``ServeConfig.fused_select=True``; the dense-logits
decode path is not ported yet).

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
"""
from __future__ import annotations

import bisect
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

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
    """Decode state of the lane batch: canvases and KV cache on the device,
    per-lane bookkeeping on the host (the host loop reads it every
    iteration anyway)."""

    def __init__(self, tokens, cache, n_blocks: int, tau: float, eos: int):
        N = tokens.shape[0]
        self.tokens = tokens                       # (N, P+G) on the device
        self.cache = cache                         # dense KV cache
        self.blk = np.zeros((N,), np.int64)        # current block per lane
        self.lane_nblocks = np.full((N,), n_blocks, np.int64)
        self.live = np.zeros((N,), bool)           # occupied and unfinished
        self.steps = np.zeros((N,), np.int64)      # refinement iterations
        self.taus = np.full((N,), tau, np.float32)
        self.eos = np.full((N,), eos, np.int64)
        self.calls = {"admit": 0, "refine": 0, "commit": 0}


class ContinuousEngine(_RequestStepper):
    """Slot-based continuous batching over the CDLM exact-cache strategy
    (dense layout, greedy). ``device`` defaults to the CUDA device; pass
    ``device="cpu"`` to run on the CPU (the kernels' plain versions)."""

    def __init__(self, params, cfg: ModelConfig, serve: ServeConfig,
                 prompt_len: int, *, device="cuda"):
        if serve.sampler != "cdlm":
            raise ValueError(
                "ContinuousEngine requires the 'cdlm' strategy (exact "
                f"block-causal cache); got sampler={serve.sampler!r}")
        if serve.cache_layout != "dense" or serve.page_pool_pages is not None:
            raise ValueError("repro_torch serves the dense cache layout only "
                             f"(got cache_layout={serve.cache_layout!r})")
        if serve.temperature > 0:
            raise ValueError("repro_torch serves greedy decoding only: the "
                             "engine default temperature must be 0")
        if not serve.fused_select:
            raise ValueError("repro_torch decodes through the fused select "
                             "kernel only: set ServeConfig(fused_select=True)")
        check_dense(cfg)
        self.device = resolve_device(device)
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
        self._next_id = 0
        self._reset()

    # -- state transitions ---------------------------------------------------
    def _init_state(self) -> _Slots:
        N = self.n_lanes
        T = self.spec.prompt_len + self.spec.gen_len
        tokens = torch.full((N, T), self.cfg.mask_token_id, dtype=torch.int64,
                            device=self.device)
        return _Slots(tokens, C.init_cache(self.cfg, N, T,
                                           device=self.device),
                      self.spec.n_blocks, self.spec.conf_threshold,
                      self.cfg.eos_token_id)

    def _admit(self, state: _Slots, prompts, admit, nblocks, taus, eos):
        """Write the admitted lanes' canvases, reset their cache rows,
        prefill the prompts under the block-causal mask and commit them into
        those rows (the prefill runs every lane, as the JAX engine's does,
        and commits only the admitted ones)."""
        spec = self.spec
        canvas = init_canvas(torch.as_tensor(prompts, dtype=torch.int64,
                                             device=self.device), spec,
                             self.cfg)
        rows = torch.as_tensor(admit, device=self.device)
        state.tokens = torch.where(rows[:, None], canvas, state.tokens)
        C.reset(state.cache, admit)
        out = forward(self.params, state.tokens[:, :spec.prompt_len],
                      cfg=self.cfg, device=self.device,
                      mode=masks.BLOCK_CAUSAL, prompt_len=spec.prompt_len,
                      block_size=spec.block_size, return_logits=False)
        C.commit_rows(state.cache, out.emissions, 0, admit)
        state.blk[admit] = 0
        state.lane_nblocks[admit] = nblocks[admit]
        state.live |= admit
        state.steps[admit] = 0
        state.taus[admit] = taus[admit]
        state.eos[admit] = eos[admit]
        state.calls["admit"] += 1

    def _evict(self, state: _Slots, rows) -> None:
        C.reset(state.cache, rows)
        state.live &= ~rows

    def _decode_block(self, state: _Slots, run) -> None:
        """Advance the lanes in ``run`` by one block: threshold refinement
        to completion, then the exact commit pass into each lane's rows."""
        spec, cfg, dev = self.spec, self.cfg, self.device
        P, B = spec.prompt_len, spec.block_size
        live = state.live & run
        starts = P + np.clip(state.blk, 0, spec.n_blocks - 1) * B
        pos = (torch.as_tensor(starts, device=dev)[:, None]
               + torch.arange(B, device=dev))
        live_t = torch.as_tensor(live, device=dev)
        taus = torch.as_tensor(state.taus, device=dev)[:, None]
        all_block = torch.ones((1, B), dtype=torch.bool, device=dev)
        w = unembed_matrix(self.params, cfg)
        it = 0
        while it < B:
            bt = state.tokens.gather(1, pos)
            active_t = (bt == cfg.mask_token_id).any(-1) & live_t
            # the loop condition is read back to the host: one device sync
            # per refinement iteration
            active = active_t.cpu().numpy()
            if not active.any():
                break
            hidden, _ = lane_block_forward(
                self.params, state.tokens, starts, state.cache, cfg=cfg,
                spec=spec, return_hidden=True)
            cand, conf = D.confidence_and_candidates_fused(
                hidden, w, bt, cfg.mask_token_id,
                softcap=cfg.final_logit_softcap)
            sel = D.select_threshold_in_block(conf, all_block, taus)
            sel = sel & active_t[:, None]
            state.tokens.scatter_(1, pos, torch.where(sel, cand.to(bt.dtype),
                                                      bt))
            state.steps += active
            state.calls["refine"] += 1
            it += 1

        # commit pass: recompute the finalized blocks' KV exactly, for the
        # lanes that ran, each at its own offset
        _, emissions = lane_block_forward(self.params, state.tokens, starts,
                                          state.cache, cfg=cfg, spec=spec,
                                          return_hidden=True)
        C.commit_rows(state.cache, emissions, starts, live)
        state.calls["commit"] += 1

        bt = state.tokens.gather(1, pos)
        eos_hit = (bt == torch.as_tensor(state.eos, device=dev)[:, None]
                   ).any(-1).cpu().numpy()
        state.blk = np.where(live, state.blk + 1, state.blk)
        finished = live & (eos_hit | (state.blk >= state.lane_nblocks))
        state.live &= ~finished

    # -- host-side scheduler -------------------------------------------------
    def _reset(self) -> None:
        self._state = self._init_state()
        self._queue: List[GenerationRequest] = []
        self._flights: List[Optional[_Flight]] = [None] * self.n_lanes
        self._resolved: Dict[int, ResolvedSamplingParams] = {}
        self._arrival: Dict[int, float] = {}
        self._t0 = time.perf_counter()
        self._live_samples: List[int] = []

    def warmup(self) -> None:
        """Build and load the kernels and run one admission and one block
        decode on a throwaway state."""
        state = self._init_state()
        N, P = self.n_lanes, self.spec.prompt_len
        everyone = np.ones((N,), bool)
        self._admit(state, np.zeros((N, P), np.int64), everyone,
                    state.lane_nblocks, state.taus, state.eos)
        self._decode_block(state, everyone)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

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

    def add_request(self, request: GenerationRequest) -> int:
        """Enqueue one request (admitted at the next block boundary with a
        free lane); returns its unique id."""
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
        at once without touching any other lane."""
        for i, r in enumerate(self._queue):
            if r.id == request_id:
                del self._queue[i]
                self._resolved.pop(request_id, None)
                self._arrival.pop(request_id, None)
                return True
        for lane, fl in enumerate(self._flights):
            if fl is not None and fl.req.id == request_id:
                row = np.zeros((self.n_lanes,), bool)
                row[lane] = True
                self._evict(self._state, row)
                self._flights[lane] = None
                self._resolved.pop(request_id, None)
                self._arrival.pop(request_id, None)
                return True
        return False

    def step(self) -> List[BlockEvent]:
        """Advance one block boundary: admit arrived requests into free
        lanes, decode one block for every running lane, evict finished
        lanes. Returns one :class:`BlockEvent` per block finalized (final
        blocks carry the request's :class:`GenerationOutput`)."""
        N, P, B = self.n_lanes, self.spec.prompt_len, self.spec.block_size
        state = self._state
        now = time.perf_counter() - self._t0
        run = np.asarray([f is not None for f in self._flights])

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

        self._live_samples.append(int(run.sum()))
        self._decode_block(state, run)
        live = state.live
        toks = state.tokens.cpu().numpy()
        t_done = time.perf_counter() - self._t0

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
                self._arrival.pop(fl.req.id, None)
            events.append(ev)
        return events

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
