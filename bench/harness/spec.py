"""``BENCHMARK.json`` and the files it names, each found by name.

- a configuration ``<name>``: the file its entry names (``file``), under
  ``bench/configs/``;
- a traffic mix ``<traffic>``: ``bench/mixes/<traffic>.json``;
- a cell's limits of ``correct``: ``bench/limits/<workload>.json``;
- a per-layer metric ``<name>``: the reader ``bench/metrics/<name>.py``;
- a kernel's count ``<name>``: ``bench/counts/<name>.py``;
- a configuration's plain reference: ``bench/reference/<reference>.py``,
  named by the configuration's file.

So a later change adds a cell, a mix or a metric as new files and entries,
and edits no file that is there.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
import sys
from pathlib import Path
from typing import Dict, List

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""
    root: Path
    name: str
    chips: int
    config: dict                  # the configuration's file
    mix: dict                     # the traffic mix's file
    limits: dict                  # the cell's limits of ``correct``
    end_to_end: List[dict]        # the metrics this cell reports, trace 0
    per_layer: List[dict]         # the metrics this cell reports, trace 1


def bench_dir(root: Path) -> Path:
    return Path(root) / "bench"


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _file(root: Path, kind: str, name: str, ext: str) -> Path:
    if not NAME.match(name):
        raise ValueError(f"{kind} name {name!r} is not a benchmark name")
    path = bench_dir(root) / kind / f"{name}{ext}"
    if not path.is_file():
        raise FileNotFoundError(f"no file under {kind}/ for {name!r}: "
                                f"{path}")
    return path


def load_cell(root: Path, workload: str) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``; raises where a
    file it names is missing."""
    root = Path(root)
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(root / configs[w["config"]]["file"])
    mix = _json(_file(root, "mixes", w["traffic"], ".json"))
    limits = _json(_file(root, "limits", workload, ".json"))
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m
                     else m["moves"] in e2e_names)]
    return Cell(root=root, name=workload, chips=int(w["chips"]),
                config=config, mix=mix, limits=limits, end_to_end=e2e,
                per_layer=per_layer)


def load_module(root: Path, kind: str, name: str):
    """The module ``bench/<kind>/<name>.py``, imported from its file once
    per process under the name ``bench_<kind>_<name>``."""
    mod_name = f"bench_{kind}_{name}".replace("-", "_").replace(".", "_")
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    path = _file(root, kind, name, ".py")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = module
    spec.loader.exec_module(module)
    return module


def readers(cell: Cell) -> Dict[str, object]:
    """The reader module of each per-layer metric of ``cell``, by name."""
    return {m["name"]: load_module(cell.root, "metrics", m["name"])
            for m in cell.per_layer}
