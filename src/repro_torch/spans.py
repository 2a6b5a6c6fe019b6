"""Named phases of the host's work, timed always and shown to a profiler.

A :class:`Phases` belongs to one engine and names its phases once.
``phases("engine.step")`` hands out that phase's one context object;
entering and leaving it adds one to the phase's count and the
``time.perf_counter_ns()`` between the two to its total. While a
profiler records (``torch.autograd._profiler_enabled()``) the phase also
opens a ``torch.profiler.record_function`` range of its name, which lands
in the profiler's trace beside the kernels, on their clock. The profiler
being on is the only switch: with it off a phase costs two clock reads
and that one test, and allocates nothing.

A phase's object is reused, so a phase does not nest in itself; phases
of other names nest freely. Use them on the host only, never inside a
function a CUDA graph captures (a replay runs no Python).
"""
from __future__ import annotations

from time import perf_counter_ns
from typing import Dict

import torch

_profiler_enabled = torch.autograd._profiler_enabled


class _Phase:
    __slots__ = ("name", "total", "t0", "range")

    def __init__(self, name: str, total: list):
        self.name = name
        self.total = total          # [count, ns], shared with the Phases
        self.t0 = 0
        self.range = None

    def __enter__(self):
        if _profiler_enabled():
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.t0 = perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = perf_counter_ns() - self.t0
        total = self.total
        total[0] += 1
        total[1] += dt
        if self.range is not None:
            rng, self.range = self.range, None
            rng.__exit__(exc_type, exc, tb)
        return False


class Phases:
    """Count and host time of each of a fixed set of named phases since
    the last :meth:`reset`, and the context object of each."""

    def __init__(self, names):
        self._totals: Dict[str, list] = {name: [0, 0] for name in names}
        self._phases = {name: _Phase(name, total)
                        for name, total in self._totals.items()}

    def __call__(self, name: str) -> _Phase:
        return self._phases[name]

    def reset(self) -> None:
        for total in self._totals.values():
            total[0] = total[1] = 0

    def stats(self) -> Dict[str, Dict[str, float]]:
        """``{name: {"count", "seconds"}}`` of every phase."""
        return {name: {"count": count, "seconds": ns * 1e-9}
                for name, (count, ns) in self._totals.items()}
