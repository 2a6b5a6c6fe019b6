"""One run of one cell: set-up, the measured window, the metrics, the
check, the result's line.

Set-up: the weights drawn on the device, the engine built on the mix's
settings and warmed (``ContinuousEngine.warmup``: the kernel library
loaded from the checkout's ``build/kernels/``, built there by the first
run only, and the CUDA graphs of the iteration variants the cell uses
and of the commit captured), and the recorder's ring allocated, so
nothing compiles, captures or allocates for the check inside the window.
``setup_s`` runs from the process's start to the window's open.

After the window: ``memory_peak_bytes`` is read, the engine freed, the
trace reduced, and the judged requests compared with the reference.
"""
from __future__ import annotations

import gc
import time
from typing import Dict, List, Optional

import numpy as np

from harness import check as CK
from harness import peaks
from harness import spec as SP
from harness import trace as TR
from harness import traffic as TF
from harness import weights as WT
from harness import window as WD

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules) -> List[str]:
    """Loaded modules whose top-level name is the JAX stack's or the JAX
    package's, compared whole."""
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)


def model_config(model: dict):
    from repro_torch.configs.base import ModelConfig
    kw = dict(model)
    kw["layer_period"] = tuple(tuple(p) for p in kw["layer_period"])
    return ModelConfig(**kw)


def percentile(values, q: float) -> float:
    """The q-th percentile by linear interpolation between order
    statistics (numpy's default)."""
    return float(np.percentile(np.asarray(values, float), q))


class Context:
    """What a per-layer metric's reader reads: the configuration, the mix,
    the window, the trace (None without one) and the counts by name."""

    def __init__(self, cell: SP.Cell, win: WD.Window,
                 trace: Optional[TR.Trace]):
        self.cell = cell
        self.model = cell.config["model"]
        self.mix = cell.mix
        self.block = int(cell.mix["engine"]["block_size"])
        self.prompt_len = int(cell.mix["prompt_len"])
        self.fused_select = bool(cell.mix["engine"]["fused_select"])
        self.win = win
        self.trace = trace
        self.bound_s = peaks.bound_s
        self.peaks = peaks.H100
        self.traced_steps = [st for st in win.steps if st.traced]
        self.group_s = trace.group_seconds() if trace is not None else {}

    def count(self, name: str):
        return SP.load_module(self.cell.root, "counts", name)

    def cache_lens(self, step: WD.Step) -> List[int]:
        """The cache rows each lane that ran in ``step`` read: its prompt
        and the blocks it had committed."""
        return [self.prompt_len + self.block * b for _, b, _ in step.events]

    @staticmethod
    def admitted(step: WD.Step) -> int:
        return sum(1 for _, b, _ in step.events if b == 0)

    @staticmethod
    def iters(step: WD.Step) -> int:
        return step.it1 - step.it0

    def delta(self, key: str) -> int:
        return self.win.counts1[key] - self.win.counts0[key]


def end_to_end(cell: SP.Cell, win: WD.Window, setup_s: float) -> Dict[str, float]:
    """The window's end-to-end numbers, over all of its work and time."""
    tokens = 0
    for st in win.steps:
        for rid, b, toks in st.events:
            cap = win.specs[rid].max_tokens
            tokens += max(0, min(len(toks), cap - b * len(toks)))
    ttfb, gaps = [], []
    for rid, t_sent in win.sent.items():
        times = win.block_times[rid]
        ttfb.append((times[0] if times else win.end) - t_sent)
        gaps += [b - a for a, b in zip(times, times[1:])]
    return {"tokens_per_s": tokens / win.seconds,
            "ttfb_p95_ms": 1e3 * percentile(ttfb, 95),
            "block_gap_p95_ms": 1e3 * percentile(gaps, 95) if gaps else None,
            "setup_s": setup_s,
            "_ttfb_n": len(ttfb), "_gaps_n": len(gaps), "_tokens": tokens}


def run_cell(root, workload: str, *, seed: int, seconds: float, trace: bool,
             device: str, t_start: float, log=print,
             readings: bool = False, control: bool = False,
             record: bool = True, mix: Optional[dict] = None) -> dict:
    """One run; returns the result's line as a dict. For the readings
    behind the limits and the tools (never in the benchmark's own runs):
    ``readings`` adds every number the check read (``result["numbers"]``),
    ``control`` the control's (``check.judge(control=True)``,
    ``result["control"]``); ``record=False`` runs the window without the
    recorder and judges nothing (``correct`` None), to measure what the
    recorder costs; ``mix`` takes the place of the cell's mix file."""
    import torch

    from repro_torch.configs.base import ServeConfig
    from repro_torch.serving import ContinuousEngine

    cell = SP.load_cell(root, workload)
    if mix is not None:
        cell.mix = mix
    mix, model = cell.mix, cell.config["model"]
    if any(float(m["temperature"]) > 0 for m in mix["modes"]):
        raise ValueError("the check judges greedy requests only: a mix "
                         "that samples cannot be judged (check.py)")
    eng = mix["engine"]
    cuda = device == "cuda"
    dev = torch.device(device)
    readers = SP.readers(cell) if trace else {}
    reference = SP.load_module(root, "reference", cell.config["reference"])

    cfg = model_config(model)
    dtype = getattr(torch, model["dtype"])
    params = WT.draw(reference.layout(model), model, seed, dev, dtype)
    serve = ServeConfig(max_batch=int(eng["lanes"]),
                        block_size=int(eng["block_size"]),
                        gen_length=int(eng["gen_length"]),
                        conf_threshold=float(eng["conf_threshold"]),
                        scheduler="continuous",
                        cache_layout=eng["cache_layout"],
                        page_pool_pages=eng.get("page_pool_pages"),
                        fused_select=bool(eng["fused_select"]))
    engine = ContinuousEngine(params, cfg, serve, int(mix["prompt_len"]),
                              device=device)
    engine.warmup()
    recorder = (WD.Recorder(engine, capacity=int(
        1.25 * seconds * float(mix["check"]["iters_per_s"])) + 64)
        if record else None)
    stream = TF.ClosedLoop(mix, vocab_size=model["vocab_size"],
                           special_ids=(model["mask_token_id"],
                                        model["eos_token_id"]),
                           block_size=serve.block_size, seed=seed)
    tracer = None
    if trace:
        tracer = TR.Tracer(torch, mix["trace"], cuda=cuda)
        tracer.warm()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    win = WD.drive(engine, stream, seconds=seconds, recorder=recorder,
                   tracer=tracer)
    if cuda:
        torch.cuda.synchronize()
    mem_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if tracer is not None:
        tracer.close()
    tr = tracer.reduce() if tracer is not None else None
    if tr is not None and not cuda:
        tr = None       # a CPU run gives no device metric
    log(f"window {win.seconds:.3f} s, {len(win.steps)} steps, "
        f"{len(win.sent)} requests sent, {len(win.outputs)} finished")

    if not record:
        del engine
        gc.unfreeze()
        numbers, checks, correct, control_numbers = {}, {}, None, None
    else:
        if recorder.overflow:
            log(f"the recorder's ring held {recorder.capacity} iterations; "
                f"{recorder.overflow} more were allocated in the window")
        # the program's state goes before the reference runs
        picks = CK.sample(win, recorder, seed=seed,
                          min_tokens=int(mix["check"]["min_tokens"]))
        judged = CK.collect(win, recorder, picks,
                            prompt_len=int(mix["prompt_len"]),
                            mask_id=model["mask_token_id"])
        recorder.free()
        engine._replay = recorder.replay = None
        del engine, recorder
        gc.unfreeze()
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        if judged:
            numbers = CK.judge(params, model, reference, judged,
                               tau=serve.conf_threshold)
        else:
            # nothing finished to judge: no reading, and not correct
            numbers = dict.fromkeys(("choice_gap", "token_gap", "order_gap",
                                     "unfinished"))
            numbers.update(judged_requests=0, judged_tokens=0, seconds=0.0)
        checks = CK.compare(numbers, cell.limits)
        control_numbers = (CK.judge(params, model, reference, judged,
                                    tau=serve.conf_threshold, control=True)
                           if control and judged else None)
        correct = bool(judged) and all(c["value"] <= c["limit"]
                                       for c in checks.values())
        log(f"judged {numbers['judged_requests']} requests, "
            f"{numbers['judged_tokens']} tokens in "
            f"{numbers['seconds']:.1f} s: token_gap {numbers['token_gap']}, "
            f"order_gap {numbers['order_gap']}")

    if trace:
        ctx = Context(cell, win, tr)
        metrics = {}
        for m in cell.per_layer:
            value = readers[m["name"]].read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    else:
        e2e = end_to_end(cell, win, setup_s)
        log(f"tails from {e2e['_ttfb_n']} first blocks and "
            f"{e2e['_gaps_n']} block gaps; {e2e['_tokens']} tokens")
        metrics = {m["name"]: {"value": float(e2e[m["name"]]),
                               "unit": m["unit"]}
                   for m in cell.end_to_end if e2e[m["name"]] is not None}
    result = {"correct": correct, "attempted": len(win.sent) + win.refused,
              "failed": win.refused, "metrics": metrics,
              "device": device_info(torch, cuda, mem_peak, tr)}
    if tr is not None:
        result["breakdown"] = {"device_ops": tr.top_ops(),
                               "idle_gaps": tr.idle_gaps()}
        log(f"trace: {len(tr.kernels)} device events, {len(tr.ranges)} "
            f"steps over {tr.window_s():.3f} s, read in {tr.read_s:.1f} s; "
            f"groups {tr.group_seconds()}")
        for t, n, name in tr.top_kernels():
            log(f"  kernel {t:.4f} s x{n} {name[:150]}")
    if readings:
        result["numbers"] = numbers
    if control_numbers is not None:
        result["control"] = control_numbers
    result["checks"] = checks
    return result


def device_info(torch, cuda: bool, mem_peak: int, tr) -> dict:
    if not cuda:
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "memory_peak_bytes": int(mem_peak)}
    if tr is not None:
        info["busy_s"] = tr.busy_s()
        info["window_s"] = tr.window_s()
    return info
