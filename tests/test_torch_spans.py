"""The continuous engine's phases (``repro_torch/spans.py``,
``ContinuousEngine.phase_stats``) and the benchmark's readers of them
(``bench/harness/phases.py``, ``bench/metrics/``), on the CPU.

Under ``torch.profiler`` every phase is a range of its name, nested as
``phase_stats`` documents, one ``engine.refine`` per refinement iteration
and one ``engine.admit`` per admission; the profiler changes no token,
step or call; without it no range is entered and the host-clock counts
match the call counts. The readers give hand-computed values on a trace
made by hand, nothing where the ranges are missing, and the three parts
of the idle time add up to all of it."""
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import spans  # noqa: E402
from repro_torch.bridge import init_params  # noqa: E402
from repro_torch.configs import ServeConfig, get_config  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    ContinuousEngine,
    Request,
    SamplingParams,
)
from repro_torch.serving.engine import PHASES  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT / "bench") not in sys.path:
    sys.path.insert(0, str(ROOT / "bench"))
from harness import phases as PH  # noqa: E402
from harness import spec as SP  # noqa: E402
from harness import trace as TR  # noqa: E402

torch.set_num_threads(2)

CFG = get_config("qwen2-0.5b").reduced(dtype="float32")
P, G, B = 8, 16, 4
PARENT = {"engine.step": None, "engine.schedule": "engine.step",
          "engine.admit": "engine.step", "engine.block": "engine.step",
          "engine.finish": "engine.step", "engine.sync": "engine.block",
          "engine.refine": "engine.block", "engine.commit": "engine.block"}
LAYOUTS = ["dense", "paged"]
READERS = ("loop_idle_ms_per_iter", "boundary_idle_ms_per_step",
           "admit_wall_ms")


@pytest.fixture(scope="module")
def params():
    p = init_params(CFG, torch.Generator().manual_seed(0), "cpu")
    p["embed"]["tok"] *= 40.0          # a sharp head: iterations finalize >1
    p["embed"]["tok"][CFG.mask_token_id] = 0.0
    return p


def _engine(params, layout):
    serve = ServeConfig(max_batch=2, block_size=B, gen_length=G,
                        conf_threshold=0.5, scheduler="continuous",
                        cache_layout=layout,
                        page_pool_pages=12 if layout == "paged" else None)
    eng = ContinuousEngine(params, CFG, serve, P, device="cpu")
    eng.warmup()
    return eng


def _drain(eng, tracer=None):
    """Five requests of 1 to 4 blocks through two lanes, so admissions
    land beside lanes in flight; returns the outputs by id and the call
    counts after each step."""
    rng = np.random.default_rng(3)
    for i in range(5):
        eng.add_request(Request(
            prompt=rng.integers(2, CFG.vocab_size - 1, P),
            params=SamplingParams(max_tokens=B * (1 + i % 4))))
    outs, calls = {}, []
    while eng.has_unfinished():
        if tracer is not None and tracer.before(0.0):
            with tracer.range("bench.step"):
                events = eng.step()
            tracer.after(0.0)
        else:
            events = eng.step()
        calls.append(eng.call_counts())
        outs.update((ev.request_id, ev.output) for ev in events
                    if ev.finished)
    return outs, calls


def _traced(eng):
    tracer = TR.Tracer(torch, {"skip_s": 0.0, "min_steps": 10**9,
                               "min_s": 0.0}, cuda=False)
    outs, calls = _drain(eng, tracer)
    tracer.close()
    return outs, calls, tracer.reduce()


@pytest.fixture(scope="module", params=LAYOUTS)
def traced(params, request):
    eng = _engine(params, request.param)
    return (eng, *_traced(eng))


def test_every_phase_is_a_range_nested_as_documented(traced):
    _, _, _, tr = traced
    ranges = [(a, b, n) for n, a, b in tr.host_ops if n.startswith("engine.")]
    assert {n for _, _, n in ranges} == set(PHASES)
    for a, b, name in ranges:
        around = [(b2 - a2, n2) for a2, b2, n2 in ranges
                  if a2 <= a and b <= b2 and (a2, b2) != (a, b)]
        assert (min(around)[1] if around else None) == PARENT[name], name
    for a, b in PH.spans(tr, "engine.step"):
        assert any(s <= a and b <= e for s, e in tr.ranges)


def test_one_refine_per_iteration_and_one_admit_per_admission(traced):
    eng, _, calls, tr = traced
    last = calls[-1]
    assert len(PH.spans(tr, "engine.refine")) == last["refine"]
    assert len(PH.spans(tr, "engine.admit")) == last["admit"] >= 3
    assert len(PH.spans(tr, "engine.commit")) == last["commit"]
    assert len(PH.spans(tr, "engine.step")) == len(calls) == len(tr.ranges)
    # step by step: each step's refine ranges are the rise of its count
    rises = np.diff([0] + [c["refine"] for c in calls])
    refines = PH.spans(tr, "engine.refine")
    per_step = [sum(s <= a and b <= e for a, b in refines)
                for s, e in PH.spans(tr, "engine.step")]
    assert per_step == rises.tolist()


def test_the_idle_parts_of_a_cpu_trace_cover_its_span(traced):
    """No device activity on the CPU: the whole span is idle, and the
    three parts still add up to it exactly."""
    eng, _, calls, tr = traced
    split = PH.split(tr)
    assert split["idle"] == tr.span[1] - tr.span[0]
    assert split["loop"] + split["boundary"] + split["outside"] == \
        split["idle"]
    assert min(split["loop"], split["boundary"], split["outside"]) > 0
    assert split["iters"] == calls[-1]["refine"]
    assert split["steps"] == len(calls)
    assert len(PH.admit_walls(tr)) == calls[-1]["admit"]


def test_the_profiler_changes_no_token_step_or_call(params, traced):
    eng, outs, calls, _ = traced
    plain, plain_calls = _drain(_engine(params, eng.serve.cache_layout))
    assert plain_calls == calls
    assert sorted(plain) == sorted(outs)
    for rid, out in outs.items():
        np.testing.assert_array_equal(plain[rid].tokens, out.tokens)
        assert (plain[rid].steps, plain[rid].gen_length) == \
            (out.steps, out.gen_length)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_without_a_profiler_no_range_and_counts_match(params, layout,
                                                      monkeypatch):
    eng = _engine(params, layout)
    assert all(s["count"] == 0 for s in eng.phase_stats().values())

    def refused(name):
        raise AssertionError(f"record_function({name!r}) without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    _, calls = _drain(eng)
    stats = {k: s["count"] for k, s in eng.phase_stats().items()}
    last = calls[-1]
    assert stats["engine.step"] == stats["engine.schedule"] == len(calls)
    assert stats["engine.admit"] == last["admit"]
    assert stats["engine.refine"] == last["refine"]
    assert (stats["engine.block"] == stats["engine.commit"]
            == stats["engine.finish"] == last["commit"])
    # one read of ``active`` per iteration, and one more per block that
    # ends before ``block_size`` iterations
    assert last["refine"] < stats["engine.sync"] <= (last["refine"]
                                                     + last["commit"])
    sec = {k: s["seconds"] for k, s in eng.phase_stats().items()}
    inner = sum(sec[k] for k, p in PARENT.items() if p == "engine.step")
    assert 0 < inner <= sec["engine.step"]
    assert 0 < sec["engine.sync"] + sec["engine.refine"] + \
        sec["engine.commit"] <= sec["engine.block"]


def test_phases_count_time_and_reset():
    ph = spans.Phases(["a", "b"])
    assert ph("a") is ph("a")
    with ph("a"):
        with ph("b"):
            pass
    with ph("a"):
        pass
    st = ph.stats()
    assert (st["a"]["count"], st["b"]["count"]) == (2, 1)
    assert st["a"]["seconds"] >= st["b"]["seconds"] > 0
    ph.reset()
    assert ph.stats() == {"a": {"count": 0, "seconds": 0.0},
                          "b": {"count": 0, "seconds": 0.0}}
    with pytest.raises(ValueError), ph("a"):
        raise ValueError("the phase is closed and counted all the same")
    assert ph.stats()["a"]["count"] == 1


def _hand_trace(admit=True, engine=True):
    """Two steps on a made-up clock (ns). Step 1 admits (its prefill holds
    up the first read of ``active``) and refines twice; step 2 refines
    once. The idle parts by hand: loop 160 + 150, boundary 230 + 120,
    outside 10 + 20 + 10, of 700 idle ns."""
    kernels = [(f"k{i}", a, b) for i, (a, b) in enumerate(
        [(100, 290), (350, 490), (560, 690), (750, 860), (920, 940),
         (1150, 1290), (1320, 1470), (1510, 1530)])]
    host = [("engine.step", 10, 990), ("engine.schedule", 10, 40),
            ("engine.admit", 40, 200), ("engine.block", 200, 900),
            ("engine.sync", 210, 300), ("engine.refine", 300, 320),
            ("engine.sync", 320, 500), ("engine.refine", 500, 520),
            ("engine.sync", 520, 700), ("engine.commit", 700, 880),
            ("engine.finish", 900, 990),
            ("engine.step", 1010, 1590), ("engine.schedule", 1010, 1030),
            ("engine.block", 1030, 1500), ("engine.sync", 1030, 1100),
            ("engine.refine", 1100, 1120), ("engine.sync", 1120, 1300),
            ("engine.commit", 1300, 1480), ("engine.finish", 1500, 1590),
            ("cudaGraphLaunch", 300, 320), ("aten::copy_", 950, 980)]
    if not admit:
        host = [h for h in host if h[0] != "engine.admit"]
    if not engine:
        host = [h for h in host if not h[0].startswith("engine.")]
    return TR.Trace(kernels=kernels, ranges=[(0, 1000), (1000, 1600)],
                    host_ops=host)


def _read(name, trace):
    return SP.load_module(ROOT, "metrics", name).read(
        SimpleNamespace(trace=trace))


def test_readers_give_hand_computed_values():
    tr = _hand_trace()
    assert _read("loop_idle_ms_per_iter", tr) == pytest.approx(
        1e-6 * 310 / 3)
    assert _read("boundary_idle_ms_per_step", tr) == pytest.approx(
        1e-6 * 350 / 2)
    assert _read("admit_wall_ms", tr) == pytest.approx(1e-6 * 260)
    assert PH.split(tr) == {"loop": 310, "boundary": 350, "outside": 40,
                            "idle": 700, "steps": 2, "iters": 3}


def test_the_idle_parts_sum_to_the_busy_complement():
    tr = _hand_trace()
    split = PH.split(tr)
    assert split["loop"] + split["boundary"] + split["outside"] == \
        split["idle"]
    assert split["idle"] * 1e-9 == pytest.approx(tr.window_s() - tr.busy_s(),
                                                 rel=1e-12)
    # the loop per iteration times the iterations, and so on, give the
    # device's idle share of the span back
    idle_share = 1 - tr.busy_s() / tr.window_s()
    parts = (_read("loop_idle_ms_per_iter", tr) * split["iters"]
             + _read("boundary_idle_ms_per_step", tr) * split["steps"]
             + 1e-6 * split["outside"])
    assert parts * 1e-3 == pytest.approx(idle_share * tr.window_s())


@pytest.mark.parametrize("missing", ["trace", "engine", "admit"])
def test_readers_find_nothing_where_a_range_is_missing(missing):
    tr = {"trace": None, "engine": _hand_trace(engine=False),
          "admit": _hand_trace(admit=False)}[missing]
    got = {name: _read(name, tr) for name in READERS}
    if missing == "admit":
        assert got["admit_wall_ms"] is None
        assert got["loop_idle_ms_per_iter"] == pytest.approx(1e-6 * 310 / 3)
    else:
        assert got == dict.fromkeys(READERS)
