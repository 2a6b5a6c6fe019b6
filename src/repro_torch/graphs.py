"""The compiled step boundary: a CUDA graph of one step, the port's
counterpart of the JAX package's ``jax.jit`` of the continuous engine's
state transitions (``serving/engine.py``) and of the collector
(``training/trainer.py``).

A :class:`Graph` captures a callable that reads and writes tensors at
fixed addresses (static inputs) and returns tensors that each replay
rewrites in place (static outputs). The host loop around it stays what it
was: it writes the static inputs, replays, and reads what it needs.

The kernels' wrappers count their launches in Python
(``decode_attention.launches`` and the like), and a replay runs no Python.
So the graph records how much each counter rose while it was captured,
takes that back (the capture launched nothing), and adds it again at every
replay: a counter still counts the kernel's launches.

There is no fallback: a capture that fails raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.block_attn import flash_block_attention
from repro_torch.kernels.decode_attn import (
    decode_attention,
    paged_decode_attention,
)
from repro_torch.kernels.select import fused_select
from repro_torch.kernels.xent import fused_xent

# every kernel wrapper's launch counter: (wrapper, attribute)
COUNTERS = ((decode_attention, "launches"),
            (paged_decode_attention, "launches"),
            (flash_block_attention, "launches"),
            (fused_select, "launches"),
            (fused_xent, "launches"),
            (fused_xent, "backward_launches"))


def _counts():
    return [getattr(fn, attr) for fn, attr in COUNTERS]


def _add(deltas) -> None:
    for (fn, attr), d in zip(COUNTERS, deltas):
        setattr(fn, attr, getattr(fn, attr) + d)


class Graph:
    """``fn()`` captured into a ``torch.cuda.CUDAGraph``.

    ``fn`` runs once first on a side stream, as PyTorch requires before a
    capture (the kernels are built and loaded, the TMA maps of fixed
    operands encoded, the library handles made); that run is real and
    counted, and ``warm`` is its result. Then ``fn`` is captured on the same
    stream, into ``pool`` (a ``torch.cuda.graph_pool_handle()`` that graphs
    replayed in their capture order may share). :meth:`replay` launches the
    captured work on the current stream and returns ``out``, the captured
    call's result, which every replay rewrites."""

    def __init__(self, fn, *, pool=None):
        side = torch.cuda.Stream()
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
