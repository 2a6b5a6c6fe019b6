"""The port's examples (``examples/*_torch.py``) run to their end on the
CPU at their smallest budgets: the quickstart pipeline, the configurable
trainer (a dense config with LoRA and a checkpoint, the attention-free
AR path) and blockwise serving (every sampler's row, streaming, and the
toy pair trained in memory by ``--steps``)."""
import importlib.util
import math

import pytest

torch = pytest.importorskip("torch")

from _torch_dist import ROOT  # noqa: E402

torch.set_num_threads(2)

TINY = ["--device", "cpu", "--teacher-steps", "2", "--student-steps", "2",
        "--examples", "16", "--eval", "8"]


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart(capsys):
    out = _load("quickstart_torch").main(TINY)
    assert "student (CDLM, KV cache)" in capsys.readouterr().out
    assert 0.0 <= out["student_score"] <= 1.0
    assert out["teacher_steps"] > 0 and out["student_steps"] > 0
    assert 0 <= out["student_gen_length"] <= 10


def test_train_cdlm_lora_and_checkpoint(tmp_path):
    prefix = str(tmp_path / "ck")
    out = _load("train_cdlm_torch").main(TINY + ["--lora", "--task", "add",
                                                 "--save", prefix])
    assert math.isfinite(out["student_score"])
    assert (tmp_path / "ck_teacher.npz").exists()
    assert (tmp_path / "ck_student.npz").exists()


def test_train_cdlm_attention_free(tmp_path, capsys):
    assert _load("train_cdlm_torch").main(
        TINY + ["--arch", "rwkv6-1.6b", "--save",
                str(tmp_path / "rw")]) == {}
    assert "training the AR path" in capsys.readouterr().out
    assert (tmp_path / "rw_ar.npz").exists()


def test_serve_blockwise(tmp_path, monkeypatch):
    mod = _load("serve_blockwise_torch")
    # assets of their own: another test file trains the shared smoke ones
    monkeypatch.setattr(mod.common, "ASSETS", str(tmp_path))
    args = ["--device", "cpu", "--smoke", "--requests", "8", "--batch", "4"]
    table = mod.main(args)
    assert [(r["sampler"], r["scheduler"]) for r in table] == [
        (s, "static") for s in mod.SAMPLERS] + [("cdlm", "continuous")]
    for row in table:
        assert row["n"] == 8 and row["steps"] > 0 and row["tps"] >= 0
    events = mod.main(args + ["--stream"])
    assert sum(e.finished for e in events) == 6


def test_serve_blockwise_trains_its_assets():
    """``--steps`` trains the toy pair in memory; at 60 steps every
    decoder emits tokens before EOS (the budget the card's smoke run
    holds the examples to)."""
    mod = _load("serve_blockwise_torch")
    table = mod.main(["--device", "cpu", "--steps", "60", "--requests",
                      "8", "--batch", "8", "--sampler", "cdlm"])
    assert [(r["sampler"], r["scheduler"]) for r in table] == [
        ("cdlm", "static"), ("cdlm", "continuous")]
    for row in table:
        assert row["n"] == 8 and row["gen_length"] > 0
