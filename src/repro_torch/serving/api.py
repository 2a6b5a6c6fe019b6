"""Request-level serving API types, a copy of the JAX package's
``serving/api.py`` (which the port cannot import: it reads that package's
configs).

- :class:`SamplingParams` — per-request knobs. Every field defaults to
  ``None`` = "inherit the engine's :class:`ServeConfig`". One batch can
  mix greedy and sampled requests; each sampled request draws from its own
  stream, ``PRNGKey(seed)`` (``repro_torch.prng``), so it decodes as it
  does alone. A ``fused_select`` engine serves greedy requests only.

- :class:`GenerationRequest` — one unit of work: a prompt plus its
  params. ``id=None`` lets the engine auto-assign a unique monotonically
  increasing id (explicit ids must be unique within a call/engine).
  Exported as ``Request`` for backward compatibility; the legacy
  ``max_tokens`` field is honored when ``params.max_tokens`` is unset.

- :class:`BlockEvent` — the streaming unit. CDLM's block-causal
  finalization makes exact block-at-a-time streaming natural: a committed
  block never changes, so the engine emits it the moment it finalizes.
  Concatenating a request's block events reproduces the generated span of
  its :class:`GenerationOutput` token-for-token (trim to ``gen_length``).

- :class:`GenerationOutput` — the final per-request result (exported as
  ``Response`` for backward compatibility). ``finish_reason`` follows the
  OpenAI convention: ``"stop"`` when the (per-request) EOS token appeared,
  ``"length"`` when the generation budget ran out.

Request lifecycle against the incremental engine core::

    rid = engine.add_request(GenerationRequest(prompt, params=sp))
    while engine.has_unfinished():
        for ev in engine.step():          # blocks finalized this boundary
            consume(ev)                   # ev.output set when ev.finished
    # or: engine.abort(rid) at any block boundary

``engine.generate(requests)`` and ``engine.stream(requests)`` are thin
wrappers that drain the stepper.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig, ServeConfig


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling parameters; ``None`` inherits ``ServeConfig``.

    temperature: 0 = greedy argmax; > 0 = categorical over
        ``softmax(logits / T)`` with a per-request RNG stream.
    conf_threshold: τ of the threshold finalize rule (CDLM §4.3).
    max_tokens: generation cap; the continuous engine rounds it up to a
        whole number of blocks, the static engine trims the returned span.
    seed: RNG seed for sampled decoding. Unset → derived from the request
        id, so re-serving the same id reproduces the same stream.
    eos_token_id: per-request stop-token override.
    """
    temperature: Optional[float] = None
    conf_threshold: Optional[float] = None
    max_tokens: Optional[int] = None
    seed: Optional[int] = None
    eos_token_id: Optional[int] = None

    @property
    def is_engine_default(self) -> bool:
        """True when no field that alters the decode loop is set —
        ``max_tokens`` alone keeps a request on the engine's scalar fast
        path (it only caps/trims, it never changes selection)."""
        return (self.temperature is None and self.conf_threshold is None
                and self.seed is None and self.eos_token_id is None)

    def resolve(self, serve: ServeConfig, cfg: ModelConfig, *,
                request_id: int,
                legacy_max_tokens: Optional[int] = None
                ) -> "ResolvedSamplingParams":
        """Fill unset fields from the engine config (and the request id
        for the default seed)."""
        max_tokens = (self.max_tokens if self.max_tokens is not None
                      else legacy_max_tokens)
        return ResolvedSamplingParams(
            temperature=(self.temperature if self.temperature is not None
                         else serve.temperature),
            conf_threshold=(self.conf_threshold
                            if self.conf_threshold is not None
                            else serve.conf_threshold),
            max_tokens=max_tokens,
            seed=self.seed if self.seed is not None else request_id,
            eos_token_id=(self.eos_token_id
                          if self.eos_token_id is not None
                          else cfg.eos_token_id))


@dataclasses.dataclass(frozen=True)
class ResolvedSamplingParams:
    """:class:`SamplingParams` with every field made concrete."""
    temperature: float
    conf_threshold: float
    max_tokens: Optional[int]
    seed: int
    eos_token_id: int


@dataclasses.dataclass
class GenerationRequest:
    """One serving request. Field order matches the legacy ``Request``
    (all call sites use keywords; ``params`` is the new trailing field)."""
    prompt: np.ndarray                       # (P,) int32
    extras: Optional[Dict[str, np.ndarray]] = None
    id: Optional[int] = None                 # None -> engine-assigned
    max_tokens: Optional[int] = None         # legacy; params.max_tokens wins
    arrival_s: float = 0.0                   # arrival offset in the trace
    params: Optional[SamplingParams] = None


#: Backward-compatible name; the engines accept either spelling.
Request = GenerationRequest


@dataclasses.dataclass
class GenerationOutput:
    """Final result of one request (legacy name: ``Response``)."""
    id: int
    tokens: np.ndarray                       # generated span (gen_len,)
    gen_length: int
    steps: int
    # static Engine: per-sample share of batch compute time (arrival_s is
    # not modeled); ContinuousEngine: true arrival -> completion, queueing
    # included. Compare throughput across engines via wall-clock, not this.
    latency_s: float
    queue_s: float = 0.0                     # arrival -> admission (continuous)
    finish_reason: str = "length"            # "stop" (EOS) | "length"


Response = GenerationOutput


@dataclasses.dataclass
class BlockEvent:
    """One finalized block, emitted by ``engine.step()`` the moment the
    block commits (block-causal finalization: it will never change)."""
    request_id: int
    index: int                               # block index in the gen span
    start: int                               # token offset = index * B
    tokens: np.ndarray                       # (block_size,) block tokens
    finished: bool = False                   # last block of the request
    output: Optional[GenerationOutput] = None  # set when finished


def normalize_requests(requests, next_id: int, *, taken=frozenset()):
    """Engine-assigned unique request ids: auto-assign monotonically from
    ``next_id`` when ``req.id`` is None, reject duplicates (within the call
    and against ``taken``, the ids already in flight). Explicit ids advance
    the counter past themselves, so auto ids never collide with any id the
    engine has already seen — completed ones included. Returns the next
    unused id. Mutates ``req.id`` in place."""
    seen = set(taken)
    for req in requests:
        if req.id is None:
            while next_id in seen:
                next_id += 1
            req.id = next_id
            next_id += 1
        elif req.id in seen:
            raise ValueError(
                f"duplicate request id {req.id}: ids must be unique within "
                "a call (leave id=None for engine-assigned unique ids)")
        else:
            next_id = max(next_id, req.id + 1)
        seen.add(req.id)
    return next_id
