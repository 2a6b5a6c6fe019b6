"""A reduced-config rehearsal of every cell through the harness on the
CPU: correct, its end-to-end metrics named as ``BENCHMARK.json`` names
them, no device metric from a CPU run, and no module of JAX or of the JAX
package loaded."""
import json
import subprocess
import sys
import textwrap

import pytest

import rehearsal as R

BENCH = json.loads((R.REPO / "BENCHMARK.json").read_text())
CELLS = [c["name"] for c in BENCH["workloads"]]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return R.make_root(tmp_path_factory.mktemp("rehearsal"))


@pytest.mark.parametrize("cell", CELLS)
def test_untraced_run(root, cell):
    logs = []
    res = R.run(root, cell, seconds=0.6, logs=logs)
    assert res["correct"] is True and res["failed"] == 0
    want = {m["name"] for m in BENCH["end_to_end"]
            if cell in m.get("workloads", [cell])}
    got = set(res["metrics"])
    # a tail needs gaps: a one-block run of a cell may have none
    assert {"tokens_per_s", "setup_s"} <= got <= want
    assert list(res)[-1] == "checks"
    assert res["device"]["platform"] == "cpu"


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_gives_no_device_metric(root, cell):
    res = R.run(root, cell, seconds=5.0, trace=True)
    device = {m["name"] for m in BENCH["per_layer"]
              if m["source"] == "device_trace" or m["name"] == "step_mfu"}
    assert not set(res["metrics"]) & device
    assert "busy_s" not in res["device"] and "breakdown" not in res
    assert res["correct"] is True


def test_no_jax_module_is_loaded(tmp_path):
    root = R.make_root(tmp_path)
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(R.REPO / 'bench' / 'tests')!r})
        import rehearsal as R
        res = R.run(__import__('pathlib').Path({str(root)!r}),
                    'dream7b-batch-greedy', seconds=0.3)
        from harness import cell as CL
        print('BAD', CL.forbidden_modules(sys.modules), res['correct'])
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    assert "BAD [] True" in out


def test_forbidden_names_are_compared_whole():
    R.paths()
    from harness import cell as CL
    assert CL.forbidden_modules(["repro_torch", "repro_torch.x", "jaxtyping",
                                 "numpy"]) == []
    assert CL.forbidden_modules(["repro", "repro.core", "jax._src",
                                 "jaxlib", "flax"]) == [
        "flax", "jax._src", "jaxlib", "repro", "repro.core"]


def test_no_card_no_result(tmp_path):
    """Without a CUDA device the command exits non-zero and prints no
    result."""
    proc = subprocess.run(
        [sys.executable, str(R.REPO / "bench" / "run.py"), "--workload",
         CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert proc.returncode != 0 and "{" not in proc.stdout
