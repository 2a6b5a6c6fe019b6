"""The device trace of a ``--trace 1`` run: ``torch.profiler`` with CPU and
CUDA activities over a steady part of the window, each ``step()`` inside
a profiler range of the harness's own (``bench.step``).

The profiled span starts at the first step that begins ``skip_s`` into the
window and lasts at least ``min_steps`` steps and ``min_s`` seconds (the
mix's ``trace``), so it holds several admission rounds. The trace is kept
in memory and reduced to kernels (name, start, end) and the harness's
ranges; nothing is written to disk.

Kernels are grouped by name as the repository's ``chip_smoke.py`` groups
them (a copy: the yardstick does not move with the program): decode
attention (``decode_attn*``, ``decode_merge*``), block attention
(``block_attn*``), the fused select (``select_*``), xent (``xent_*``),
cuBLAS matmuls (``gemm``, ``cutlass``, ``xmma``, ``nvjet``, ``sm90``) and
every other kernel ("other": PyTorch's elementwise kernels). Copies and
fills the runtime makes (``Memcpy``, ``Memset``) are "memcpy", not kernels.
"""
from __future__ import annotations

import dataclasses
from contextlib import nullcontext
from typing import Dict, List, Optional, Tuple

MATMUL_MARKS = ("gemm", "cutlass", "xmma", "nvjet", "sm90")
# host-side events of the profiler itself, which name no work of the run
PROFILER_OWN = ("Activity Buffer Request", "Iteration Start: PyTorch Profiler",
                "Record Window End")
GROUPS = ("decode_attention", "block_attention", "select", "xent", "matmul",
          "other", "memcpy")


def group(name: str) -> str:
    if name.startswith(("Memcpy", "Memset")):
        return "memcpy"
    if "decode_attn" in name or "decode_merge" in name:
        return "decode_attention"
    if "block_attn" in name:
        return "block_attention"
    if "select_" in name:
        return "select"
    if "xent_" in name:
        return "xent"
    if any(s in name.lower() for s in MATMUL_MARKS):
        return "matmul"
    return "other"


@dataclasses.dataclass
class Trace:
    """The reduced trace: device activity and the harness's step ranges,
    in ns on the profiler's clock."""
    kernels: List[Tuple[str, int, int]]     # (name, start, end)
    ranges: List[Tuple[int, int]]           # bench.step (start, end)
    host_ops: List[Tuple[str, int, int]]    # other CPU ops (name, s, e)
    read_s: float = 0.0

    @property
    def span(self) -> Tuple[int, int]:
        return self.ranges[0][0], self.ranges[-1][1]

    def device(self):
        """(name, start, end) of the device activity inside the span."""
        s0, s1 = self.span
        return [(n, max(a, s0), min(b, s1)) for n, a, b in self.kernels
                if b > s0 and a < s1]

    def group_seconds(self) -> Dict[str, float]:
        out = {g: 0.0 for g in GROUPS}
        for name, a, b in self.device():
            out[group(name)] += (b - a) * 1e-9
        return out

    def n_kernels(self) -> int:
        return sum(1 for name, _, _ in self.device()
                   if group(name) != "memcpy")

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of the device's activity intervals in the span."""
        merged: List[List[int]] = []
        for _, a, b in sorted(self.device(), key=lambda k: k[1]):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-9

    def window_s(self) -> float:
        s0, s1 = self.span
        return (s1 - s0) * 1e-9

    def idle_gaps(self, top: int = 10) -> List[list]:
        """The longest gaps between device activity inside the span, each
        named by the innermost host op open at its middle."""
        s0, s1 = self.span
        edges = [s0] + [x for iv in self.busy_intervals() for x in iv] + [s1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:top]:
            mid = (a + b) // 2
            inner = [(e - s, n) for n, s, e in self.host_ops if s <= mid < e]
            label = min(inner)[1] if inner else "bench.step"
            out.append([f"bench.step/{label}", (b - a) * 1e-9])
        return out

    def top_kernels(self, top: int = 8) -> List[tuple]:
        """(seconds, count, name) of the kernels that took most time."""
        by = {}
        for name, a, b in self.device():
            t, n = by.get(name, (0.0, 0))
            by[name] = (t + (b - a) * 1e-9, n + 1)
        return sorted(((t, n, k) for k, (t, n) in by.items()),
                      reverse=True)[:top]

    def top_ops(self, top: int = 10) -> List[list]:
        ranked = sorted(((s, g) for g, s in self.group_seconds().items()
                         if s > 0), reverse=True)
        return [[g, s] for s, g in ranked[:top]]


class Tracer:
    """Starts and stops the profiler around the steps of the span."""

    def __init__(self, torch, plan: dict, *, cuda: bool):
        self.torch = torch
        self.skip_s = float(plan["skip_s"])
        self.min_steps = int(plan["min_steps"])
        self.min_s = float(plan["min_s"])
        self.cuda = cuda
        self.prof = None
        self.done = False
        self.n = 0
        self.t_first = None

    def warm(self) -> None:
        """The process's first profiler session starts CUPTI, which takes
        seconds; a traced run pays that in set-up, not in the window."""
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts):
            self.torch.ones(8, device="cuda" if self.cuda else "cpu").sum().item()

    def before(self, t: float) -> bool:
        """Whether the step about to start at ``t`` (window seconds) is
        profiled; starts the profiler at the first."""
        if self.done or t < self.skip_s:
            return False
        if self.prof is None:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.cuda:
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.start()
            self.t_first = t
        return True

    def range(self, name: str):
        from torch.profiler import record_function
        return record_function(name) if self.prof is not None else nullcontext()

    def after(self, t: float) -> None:
        """The profiled step ended at ``t`` (window seconds); stops the
        profiler once the span is long enough."""
        self.n += 1
        if self.n >= self.min_steps and t - self.t_first >= self.min_s:
            if self.cuda:
                self.torch.cuda.synchronize()
            self.prof.stop()
            self.done = True

    def close(self) -> None:
        if self.prof is not None and not self.done:
            self.prof.stop()
            self.done = True

    def reduce(self) -> Optional[Trace]:
        """The kept part of the trace, or None where nothing was traced."""
        if self.prof is None:
            return None
        import time
        t = time.perf_counter()
        kernels, ranges, host = [], [], []
        cuda = self.torch.autograd.DeviceType.CUDA
        for ev in self.prof.profiler.kineto_results.events():
            name, a = ev.name(), ev.start_ns()
            b = a + ev.duration_ns()
            annotation = (ev.is_user_annotation()
                          if hasattr(ev, "is_user_annotation")
                          else name == "bench.step")
            if ev.device_type() == cuda:
                # kernels, copies and fills; not the device side of an
                # annotation, which spans the kernels it encloses
                if not annotation:
                    kernels.append((name, a, b))
            elif annotation and name == "bench.step":
                ranges.append((a, b))
            elif name not in PROFILER_OWN:
                host.append((name, a, b))
        self.prof = None
        if not ranges:
            return None
        ranges.sort()
        return Trace(kernels=kernels, ranges=ranges, host_ops=host,
                     read_s=time.perf_counter() - t)
