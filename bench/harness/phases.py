"""The device's idle time in a traced span, put down to the program's own
phases: the ``engine.*`` ranges that ``ContinuousEngine`` opens while a
profiler records (``repro_torch/spans.py``), which the reduced trace keeps
among its host ops (``Trace.host_ops``).

Idle is the complement of ``Trace.busy_intervals()`` inside the span. It
falls into three parts, which add up to it:

- the loop: inside ``engine.block`` and outside ``engine.commit``, that is
  between one iteration's read of ``active`` and the next graph's kernels;
- the boundary: inside ``engine.step`` and outside the loop (scheduling,
  the admission, the commit pass that closes the block, the step's end);
- outside ``engine.step``: the harness's own time between steps.

A trace of a program without these ranges has no ``engine.step``: every
reading here is then None.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

Intervals = List[Tuple[int, int]]


def spans(trace, name: str) -> Intervals:
    """(start, end) of the host ranges named ``name`` inside the span,
    in order."""
    s0, s1 = trace.span
    return sorted((a, b) for n, a, b in trace.host_ops
                  if n == name and a >= s0 and b <= s1)


def union(ivs: Intervals) -> Intervals:
    out: List[List[int]] = []
    for a, b in sorted(ivs):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def overlap(xs: Intervals, ys: Intervals) -> int:
    """ns in both of two sorted lists of disjoint intervals."""
    i = j = total = 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle(trace) -> Intervals:
    """The gaps between the device's activity inside the span."""
    s0, s1 = trace.span
    edges = [s0] + [x for iv in trace.busy_intervals() for x in iv] + [s1]
    return [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2)
            if edges[k + 1] > edges[k]]


def split(trace) -> Optional[Dict[str, int]]:
    """The span's idle ns by part (``loop``, ``boundary``, ``outside``,
    and their sum ``idle``) with the number of ``steps`` and refinement
    iterations (``iters``) the span holds; None without ``engine.step``."""
    if trace is None:
        return None
    steps = spans(trace, "engine.step")
    if not steps:
        return None
    gaps = idle(trace)
    total = sum(b - a for a, b in gaps)
    in_step = overlap(gaps, union(steps))
    in_block = overlap(gaps, union(spans(trace, "engine.block")))
    in_commit = overlap(gaps, union(spans(trace, "engine.commit")))
    return {"loop": in_block - in_commit,
            "boundary": in_step - in_block + in_commit,
            "outside": total - in_step, "idle": total, "steps": len(steps),
            "iters": len(spans(trace, "engine.refine"))}


def admit_walls(trace) -> List[int]:
    """For each ``engine.admit`` in the span, ns from its start to the end
    of the first ``engine.sync`` that starts after it: the host's first
    wait on the device after the admission, which the prefill holds up."""
    if trace is None:
        return []
    syncs = spans(trace, "engine.sync")
    starts = [a for a, _ in syncs]
    out = []
    for a, _ in spans(trace, "engine.admit"):
        k = bisect.bisect_left(starts, a)
        if k < len(syncs):
            out.append(syncs[k][1] - a)
    return out
