"""The compiled step boundary: a CUDA graph of one step, the port's
counterpart of the JAX package's ``jax.jit`` of the engines' decode (the
continuous engine's state transitions and the static engine's sampler,
``serving/engine.py``) and of the collector (``training/trainer.py``).

A :class:`Graph` captures a callable that reads and writes tensors at
fixed addresses (static inputs) and returns tensors that each replay
rewrites in place (static outputs). The host loop around it stays what it
was: it writes the static inputs, replays, and reads what it needs.

The kernels' wrappers count their launches in Python
(``decode_attention.launches`` and the like), and a replay runs no Python.
So the graph records how much each counter rose while it was captured,
takes that back (the capture launched nothing), and adds it again at every
replay: a counter still counts the kernel's launches.

A loop that runs either way takes a replay hook, ``replay(name, fn)``,
that returns ``fn()``'s result: :func:`eager` calls ``fn``, a
:class:`Graphs` runs it through its graph ``name``. So the code a graph
replays is the code the eager path runs.

There is no fallback: a capture that fails raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.block_attn import flash_block_attention
from repro_torch.kernels.decode_attn import (
    decode_attention,
    paged_decode_attention,
)
from repro_torch.kernels.elementwise import add_rmsnorm, gated_act, qkv_rope
from repro_torch.kernels.moe import (
    moe_align,
    moe_combine,
    moe_down,
    moe_gate_up,
    moe_gather,
)
from repro_torch.kernels.select import fused_select
from repro_torch.kernels.xent import fused_xent

# every kernel wrapper's launch counter: (wrapper, attribute)
COUNTERS = ((decode_attention, "launches"),
            (paged_decode_attention, "launches"),
            (flash_block_attention, "launches"),
            (fused_select, "launches"),
            (fused_xent, "launches"),
            (fused_xent, "backward_launches"),
            (add_rmsnorm, "launches"),
            (qkv_rope, "launches"),
            (gated_act, "launches"),
            (moe_align, "launches"),
            (moe_gather, "launches"),
            (moe_gate_up, "launches"),
            (moe_down, "launches"),
            (moe_combine, "launches"))


def _counts():
    return [getattr(fn, attr) for fn, attr in COUNTERS]


def _add(deltas) -> None:
    for (fn, attr), d in zip(COUNTERS, deltas):
        setattr(fn, attr, getattr(fn, attr) + d)


class Graph:
    """``fn()`` captured into a ``torch.cuda.CUDAGraph``.

    ``fn`` runs once first on a side stream (``stream``, default a new
    one), as PyTorch requires before a capture (the kernels are built and
    loaded, the TMA maps of fixed operands encoded, the library handles
    made); that run is real and counted, and ``warm`` is its result. Then
    ``fn`` is captured on the same stream, into ``pool`` (a
    ``torch.cuda.graph_pool_handle()``; the allocator reuses a pool's
    memory only within one stream, so graphs that share a pool share a
    stream too). :meth:`replay` launches the captured work on the current
    stream and returns ``out``, the captured call's result, which every
    replay rewrites."""

    def __init__(self, fn, *, pool=None, stream=None):
        side = torch.cuda.Stream() if stream is None else stream
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self.warm = fn()
        before = _counts()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool, stream=side):
            self.out = fn()
        self._deltas = [b - a for a, b in zip(before, _counts())]
        _add([-d for d in self._deltas])
        current = torch.cuda.current_stream()
        current.wait_stream(side)
        # the warm-up's result was made on the side stream and is read on
        # this one
        for t in _tensors(self.warm):
            t.record_stream(current)

    def replay(self):
        self.graph.replay()
        _add(self._deltas)
        return self.out


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


def eager(name, fn):
    """The replay hook of an eager decode: ``fn()``."""
    del name
    return fn()


class Graphs(dict):
    """Named :class:`Graph` s sharing one memory pool (and the side stream
    they are captured on), as a replay hook:
    ``graphs(name, fn)`` replays the graph ``name`` and returns its
    ``out``, or, at the first call of that name, captures ``fn`` and
    returns the capture's warm-up result (that run is the call).

    The shared pool lets one graph's intermediates reuse another's; a
    graph's ``out`` may then share memory with another graph's
    intermediates, so a caller reads each result before its next replay of
    any graph (every decode loop of the port does)."""

    def __init__(self):
        super().__init__()
        self.pool = self.stream = None

    def __call__(self, name: str, fn):
        graph = self.get(name)
        if graph is not None:
            return graph.replay()
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream()
        self[name] = Graph(fn, pool=self.pool, stream=self.stream)
        return self[name].warm
