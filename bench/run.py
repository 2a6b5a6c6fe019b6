"""Run one cell of the port's benchmark once and print its result.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for. The last line of standard output is the result: one JSON object with
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics with ``--trace 0``, its per-layer metrics with ``--trace 1``),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number the comparison with the plain reference read, beside its limit
(also the last lines of standard error).

Exits with 1 and prints no result without a CUDA device (or with fewer
than the cell asks for), or where a module of JAX or of the JAX package
``repro`` is loaded once the window has closed. Every cache of the
program is kept inside the checkout, at fixed paths under ``build/``.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _environment() -> None:
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(build / "inductor")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for path in (ROOT / "bench", ROOT / "src"):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))


def _parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _err(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    args = _parse(argv)
    _environment()
    if not (ROOT / "src" / "repro_torch").is_dir():
        _err("the program (src/repro_torch) is not in this checkout")
        return 1
    from harness import cell as CL
    from harness import spec as SP
    cell = SP.load_cell(ROOT, args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        _err(f"the cell needs {cell.chips} CUDA device(s); "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
             " available")
        return 1
    torch.set_num_threads(2)
    limit = os.popen("nvidia-smi --query-gpu=name,power.limit "
                     "--format=csv,noheader 2>/dev/null").read().strip()
    _err(f"card: {limit or torch.cuda.get_device_name(0)}")
    result = CL.run_cell(ROOT, args.workload, seed=args.seed,
                         seconds=args.seconds, trace=bool(args.trace),
                         device="cuda", t_start=T_START, log=_err)
    bad = CL.forbidden_modules(sys.modules)
    if bad:
        _err(f"modules of JAX or of the JAX package are loaded: {bad}")
        return 1
    for name, c in result["checks"].items():
        _err(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
