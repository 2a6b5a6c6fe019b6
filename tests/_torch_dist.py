"""Shared set-up of the port's ``torch.distributed`` tests: run a script
in ``world`` CPU processes joined by gloo over a loopback TCP store."""
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

PRELUDE = """
import os, sys
import torch
import torch.distributed as dist
torch.set_num_threads(1)
RANK, WORLD = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
dist.init_process_group("gloo", init_method=os.environ["INIT"],
                        rank=RANK, world_size=WORLD)
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(code: str, world: int, tmp_path, timeout: int = 180,
              env=None):
    """Run ``PRELUDE + code`` as ranks 0 .. world-1; every rank must exit
    0. Returns each rank's stdout."""
    script = Path(tmp_path) / "ranks.py"
    script.write_text(PRELUDE + textwrap.dedent(code)
                      + "\ndist.destroy_process_group()\n")
    base = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
                INIT=f"tcp://127.0.0.1:{free_port()}",
                WORLD_SIZE=str(world), **(env or {}))
    procs = [subprocess.Popen([sys.executable, str(script)],
                              env=dict(base, RANK=str(r)), cwd=tmp_path,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, f"rank failed:\n{out}\n{err}"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs
