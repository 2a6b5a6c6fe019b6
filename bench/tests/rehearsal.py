"""A copy of the benchmark at a reduced size, for the CPU tests: the
repository's ``BENCHMARK.json`` and ``bench/`` copied into a temporary
root, each configuration cut to a few layers and narrow widths, each mix
to short prompts, few lanes and clients, and the program's source linked
beside them. The harness then runs a cell there on the CPU as it runs one
on the card (the kernels' plain versions in place of the CUDA ones)."""
from __future__ import annotations

import json
import os
import shutil
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

SMALL_MODEL = {"n_layers": 2, "d_model": 64, "n_heads": 4, "head_dim": 16,
               "d_ff": 128, "vocab_size": 512, "mask_token_id": 510,
               "eos_token_id": 509, "dtype": "float32"}
SMALL_MIX = {"prompt_len": 16, "clients": 3}
SMALL_ENGINE = {"lanes": 2, "block_size": 8, "gen_length": 32}


def paths() -> None:
    for p in (REPO / "bench", REPO / "src"):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


def make_root(tmp: Path, *, model=None, mix=None, engine=None) -> Path:
    """A reduced copy of the benchmark under ``tmp``; returns its root."""
    root = Path(tmp) / "root"
    shutil.copytree(REPO / "bench", root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    os.symlink(REPO / "src", root / "src")
    for path in (root / "bench" / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        kv = 2 if cfg["model"]["n_kv_heads"] < cfg["model"]["n_heads"] else 4
        cfg["model"].update(SMALL_MODEL, n_kv_heads=kv, **(model or {}))
        path.write_text(json.dumps(cfg))
    for path in (root / "bench" / "mixes").glob("*.json"):
        m = json.loads(path.read_text())
        lanes = min(m["engine"]["lanes"], SMALL_ENGINE["lanes"])
        m.update(SMALL_MIX, clients=max(1, min(m["clients"], lanes + 1)),
                 **(mix or {}))
        m["engine"].update(SMALL_ENGINE, lanes=lanes, **(engine or {}))
        m["caps"]["blocks"] = [min(b, 4) for b in m["caps"]["blocks"]]
        m["check"]["min_tokens"] = 16
        path.write_text(json.dumps(m))
    return root


def run(root: Path, workload: str, *, seed: int = 7, seconds: float = 1.0,
        trace: bool = False, logs=None) -> dict:
    """One run of ``workload`` on the CPU from ``root``."""
    paths()
    import torch
    torch.set_num_threads(1)
    from harness import cell as CL
    return CL.run_cell(root, workload, seed=seed, seconds=seconds,
                       trace=trace, device="cpu", t_start=time.perf_counter(),
                       log=(logs.append if logs is not None
                            else lambda *_: None))
