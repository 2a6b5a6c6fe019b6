"""The port stands alone: no module of ``src/repro_torch`` (nor
``chip_smoke.py``, the port's benches, ``benchmarks/*_torch.py``, or its
examples, ``examples/*_torch.py``) imports
JAX or anything of the JAX package ``repro``.
Checked twice: every module imported in a fresh interpreter leaves no
``jax*`` / ``repro`` / ``repro.*`` entry in ``sys.modules``, and an AST scan
finds no such import statement (``repro_torch`` shares the prefix, so the
match is on the whole top-level name)."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FILES = sorted(PKG.rglob("*.py"))
MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
    .removesuffix(".__init__") for p in FILES)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top.startswith("jax") or top == "repro"


@pytest.fixture(scope="module")
def imported():
    """Import every module of the package in one fresh interpreter; if the
    union of what they pull in holds no forbidden entry, none of them
    does."""
    script = (
        "import importlib, json, sys\n"
        f"mods = {MODULES!r}\n"
        "for m in mods: importlib.import_module(m)\n"
        "print(json.dumps({'loaded': [m for m in mods if m in sys.modules],"
        " 'all': sorted(sys.modules)}))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", script], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", MODULES)
def test_import_pulls_in_no_jax(imported, module):
    assert module in imported["loaded"]
    leaked = [m for m in imported["all"] if _forbidden(m)]
    assert not leaked, leaked


@pytest.mark.parametrize("path", FILES + [ROOT / "chip_smoke.py"] + sorted(
    (ROOT / "benchmarks").glob("*_torch.py")) + sorted(
    (ROOT / "examples").glob("*_torch.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_statement_names_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, "relative import"
            names.append(node.module)
    bad = [n for n in names if _forbidden(n)]
    assert not bad, bad
