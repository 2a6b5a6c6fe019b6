"""The measured window: the closed loop driven through the engine's
``add_request`` and ``step``, with what the end-to-end metrics and the
check need recorded on the host's clock.

The window opens at the first ``step()``, after the clients' first
requests are sent (with at least as many clients as lanes, every lane is
then full), and closes at the end of the first ``step()`` that ends at
least ``seconds`` after it opened: every step of the window is whole, and
its length is the time they took together.

:class:`Recorder` keeps each refinement iteration's canvases for the check:
after every replay of an iteration the engine's canvas tensor is copied
whole, device to device (one memcpy and no kernel), into a ring of chunks
on the device, allocated in set-up. The engine's canvases are
``engine._state.tokens`` and its replay hook ``engine._replay``: the one
place the harness reaches into the engine (the program has no public
hook for it yet).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class Step:
    t0: float                 # host clock at the call
    t1: float                 # host clock at its return
    it0: int                  # recorder's iterations before the call
    it1: int                  # and after it
    events: List[tuple]       # (request id, block index, tokens) in order
    traced: bool = False


@dataclasses.dataclass
class Window:
    start: float = 0.0
    end: float = 0.0
    steps: List[Step] = dataclasses.field(default_factory=list)
    sent: Dict[int, float] = dataclasses.field(default_factory=dict)
    specs: Dict[int, object] = dataclasses.field(default_factory=dict)
    block_times: Dict[int, List[float]] = dataclasses.field(
        default_factory=dict)
    outputs: Dict[int, object] = dataclasses.field(default_factory=dict)
    counts0: Dict[str, int] = dataclasses.field(default_factory=dict)
    counts1: Dict[str, int] = dataclasses.field(default_factory=dict)
    lanes0: tuple = (0, 0.0)   # (block decodes, mean lanes) at the open
    lanes1: tuple = (0, 0.0)
    refused: int = 0

    @property
    def seconds(self) -> float:
        return self.end - self.start


class Recorder:
    """The canvases after every refinement iteration, on the device.

    The ring is allocated in set-up for ``capacity`` iterations (the
    window's seconds times the mix's bound on iterations a second, with
    room), so the window only copies; past it, a chunk more is allocated
    and ``overflow`` counts the iterations that needed one. The check
    needs exactly one replay of a refinement iteration per iteration:
    every replay the engine makes but the commit's is one iteration."""

    def __init__(self, engine, capacity: int, chunk: int = 256):
        import torch
        self._torch = torch
        self.tokens = engine._state.tokens
        self.chunk = chunk
        self.bufs = [self._chunk() for _ in range(-(-capacity // chunk))]
        self.capacity = len(self.bufs) * chunk
        self.n = 0
        self._replay = engine._replay
        engine._replay = self.replay

    def _chunk(self):
        return self._torch.empty((self.chunk, *self.tokens.shape),
                                 dtype=self.tokens.dtype,
                                 device=self.tokens.device)

    @property
    def overflow(self) -> int:
        return max(0, self.n - self.capacity)

    def replay(self, name, fn):
        out = self._replay(name, fn)
        if name != "commit":
            b, i = divmod(self.n, self.chunk)
            if b == len(self.bufs):
                self.bufs.append(self._chunk())
            self.bufs[b][i].copy_(self.tokens)
            self.n += 1
        return out

    def host(self, lo: int, hi: int, cols: slice) -> np.ndarray:
        """Iterations ``[lo, hi)``' canvases, columns ``cols``, on the
        host: (hi - lo, lanes, columns)."""
        out = []
        for i in range(lo, hi):
            b, j = divmod(i, self.chunk)
            out.append(self.bufs[b][j][:, cols])
        if not out:
            return np.zeros((0, self.tokens.shape[0], 0), np.int64)
        return self._torch.stack(out).cpu().numpy()

    def free(self) -> None:
        self.bufs = []


def _lanes(engine) -> tuple:
    """(block decodes so far, their mean lanes) of the engine's
    ``concurrency_stats``; the block decodes are its ``commit`` calls."""
    return (engine.call_counts()["commit"],
            engine.concurrency_stats()["avg_lanes"])


def drive(engine, stream, *, seconds: float, recorder: Optional[Recorder],
          tracer=None) -> Window:
    """Run the closed loop for ``seconds``; ``tracer`` (``trace.Tracer``)
    is told of every step and may profile some of them. Without a
    ``recorder`` (only to measure what it costs) no iteration is kept."""
    from repro_torch.serving import Request, SamplingParams
    clock = time.perf_counter
    win = Window()

    def send(now: float) -> None:
        spec = stream.next()
        sampled = ({"temperature": spec.temperature, "seed": spec.seed}
                   if spec.temperature > 0 else {})
        params = SamplingParams(max_tokens=spec.max_tokens, **sampled)
        req = Request(prompt=spec.prompt, params=params)
        try:
            rid = engine.add_request(req)
        except ValueError:
            win.refused += 1
            return
        win.sent[rid] = now
        win.specs[rid] = spec
        win.block_times[rid] = []

    win.counts0 = engine.call_counts()
    win.lanes0 = _lanes(engine)
    win.start = clock()
    for _ in range(stream.clients):
        send(win.start)
    iters = (lambda: recorder.n) if recorder is not None else (lambda: 0)
    while True:
        it0 = iters()
        traced = tracer is not None and tracer.before(clock() - win.start)
        t0 = clock()
        if traced:
            with tracer.range("bench.step"):
                events = engine.step()
        else:
            events = engine.step()
        t1 = clock()
        if traced:
            tracer.after(t1 - win.start)
        step = Step(t0=t0, t1=t1, it0=it0, it1=iters(), events=[],
                    traced=traced)
        win.steps.append(step)
        finished = 0
        for ev in events:
            step.events.append((ev.request_id, ev.index, ev.tokens))
            win.block_times[ev.request_id].append(t1)
            if ev.finished:
                win.outputs[ev.request_id] = ev.output
                finished += 1
        if t1 - win.start >= seconds:
            break
        now = clock()
        for _ in range(finished):
            send(now)
    win.end = t1
    win.counts1 = engine.call_counts()
    win.lanes1 = _lanes(engine)
    return win
