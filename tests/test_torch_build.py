"""The kernel build's bookkeeping on the CPU (nothing is compiled here): the
library's name hashes every file under ``*/csrc/`` (sources and the headers
they include), so an edited header rebuilds, while only ``.cu`` files are
compiled."""
import shutil

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402


@pytest.fixture
def tree(tmp_path, monkeypatch):
    """A copy of the kernel sources, with the build pointed at it."""
    root = tmp_path / "kernels"
    shutil.copytree(_build.PKG_DIR, root,
                    ignore=shutil.ignore_patterns("__pycache__"))
    monkeypatch.setattr(_build, "PKG_DIR", root)
    return root


def test_the_shared_header_is_hashed_but_not_compiled(tree):
    header = tree / "common" / "csrc" / "hopper.cuh"
    assert header in _build.hashed_files()
    assert all(p.suffix == ".cu" for p in _build.sources())
    assert tree / "xent" / "csrc" / "xent.cu" in _build.sources()
    assert header not in _build.sources()


@pytest.mark.parametrize("edited", ["common/csrc/hopper.cuh",
                                    "common/csrc/tc_mainloop.cuh",
                                    "xent/csrc/xent.cu",
                                    "select/csrc/select.cu",
                                    "block_attn/csrc/block_attn.cu",
                                    "decode_attn/csrc/decode_attn.cu"])
def test_editing_a_source_or_header_changes_the_library(tree, edited):
    before = _build.library_path()
    assert _build.library_path() == before          # stable when unchanged
    path = tree / edited
    path.write_text(path.read_text() + "\n// edited\n")
    after = _build.library_path()
    assert after != before and after.parent == before.parent


def test_the_mainloop_header_is_hashed_but_not_compiled(tree):
    header = tree / "common" / "csrc" / "tc_mainloop.cuh"
    assert header in _build.hashed_files()
    assert header not in _build.sources()
    for name in ("xent/csrc/xent.cu", "select/csrc/select.cu",
                 "block_attn/csrc/block_attn.cu",
                 "decode_attn/csrc/decode_attn.cu"):
        assert tree / name in _build.sources()
        assert '#include "../../common/csrc/tc_mainloop.cuh"' in (
            tree / name).read_text()


def test_python_files_do_not_change_the_library(tree):
    before = _build.library_path()
    (tree / "xent" / "ops.py").write_text("# edited\n")
    assert _build.library_path() == before
