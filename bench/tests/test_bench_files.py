"""Everything a cell or metric names is a file of its own, found by name;
a new mix and cell added as files are picked up with no edit."""
import json

import pytest

import rehearsal as R

R.paths()
from harness import spec as SP  # noqa: E402

BENCH = json.loads((R.REPO / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", [c["name"] for c in BENCH["workloads"]])
def test_cell_files_are_found_by_name(cell):
    c = SP.load_cell(R.REPO, cell)
    assert c.config["name"] == next(w["config"] for w in BENCH["workloads"]
                                    if w["name"] == cell)
    assert {"prompt_len", "clients", "engine", "caps", "modes", "check",
            "trace"} <= set(c.mix)
    assert {"choice_gap", "unfinished"} <= set(c.limits)
    ref = SP.load_module(R.REPO, "reference", c.config["reference"])
    assert callable(ref.block_stats)
    assert [m["name"] for m in c.end_to_end][-1] == "setup_s"


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_metric_has_a_reader(metric):
    module = SP.load_module(R.REPO, "metrics", metric)
    assert callable(module.read)


@pytest.mark.parametrize("count", ["block_attn", "decode_attn", "select",
                                   "matmul", "model_step"])
def test_counts_are_found_by_name(count):
    assert SP.load_module(R.REPO, "counts", count)


def test_a_missing_file_is_refused(tmp_path):
    root = R.make_root(tmp_path)
    (root / "bench" / "mixes" / "batch-greedy.json").unlink()
    with pytest.raises(FileNotFoundError):
        SP.load_cell(root, "dream7b-batch-greedy")


def test_a_new_mix_is_picked_up_with_no_edit(tmp_path):
    """A cell and its mix added as files (and entries) run through the
    harness; no file of the harness changes."""
    root = R.make_root(tmp_path)
    mixes = root / "bench" / "mixes"
    mix = json.loads((mixes / "batch-greedy.json").read_text())
    mix.update(clients=4, why="a new mix")
    mix["caps"] = {"blocks": [1, 2], "counts": [1, 1]}
    (mixes / "chat-pairs.json").write_text(json.dumps(mix))
    limits = root / "bench" / "limits"
    (limits / "dream7b-chat-pairs.json").write_text(
        (limits / "dream7b-batch-greedy.json").read_text())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "dream7b-chat-pairs",
                               "config": "dream-7b", "traffic": "chat-pairs",
                               "chips": 1, "why": "a new cell"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = SP.load_cell(root, "dream7b-chat-pairs")
    assert cell.mix["why"] == "a new mix"
    res = R.run(root, "dream7b-chat-pairs", seconds=0.5)
    assert res["correct"] and res["metrics"]["tokens_per_s"]["value"] > 0
