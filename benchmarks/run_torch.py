"""Bench driver of the port, the counterpart of ``benchmarks/run.py``: one
module per paper table or figure, on the card unless ``--device cpu``.

  arithmetic_intensity  Fig. 4 + App. B.4  (analytic; A100 and H100)
  kernels               the kernel layer: kernel, plain, library, bound
  main_results          Tables 1-2         (full width on the card; toy)
  step_truncation       Table 4            (toy assets)
  conf_threshold        Table 7 / App. B.2 (toy assets)
  block_size            Fig. 8 / App. B.3  (toy assets)
  loss_weights          Table 3            (toy students, one per variant)
  serving               static vs continuous, dense vs paged, preemption

JAX's ``trajectory`` (the CI's ratchet over ``BENCH_*.json``) has no
counterpart.

    python3 benchmarks/run_torch.py all                     # the card
    python3 benchmarks/run_torch.py serving --json out.json # one bench
    python3 benchmarks/run_torch.py --device cpu --smoke all

``--device`` and ``--smoke`` come before the bench's name and go to every
bench; arguments after the name go to that bench's own command line.
``all`` runs every bench and prints the ``name,us_per_call,derived`` CSV.
Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import importlib
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

MODULES = {
    "arithmetic_intensity": "bench_arithmetic_intensity_torch",
    "kernels": "bench_kernels_torch",
    "main_results": "bench_main_results_torch",
    "step_truncation": "bench_step_truncation_torch",
    "conf_threshold": "bench_conf_threshold_torch",
    "block_size": "bench_block_size_torch",
    "loss_weights": "bench_loss_weights_torch",
    "serving": "bench_serving_torch",
}


def _import(name):
    return importlib.import_module(f"benchmarks.{MODULES[name]}")


def run_all(device, smoke) -> None:
    rows = []
    t0 = time.time()
    for name in MODULES:
        mod = _import(name)
        print(f"\n##### {mod.__name__} ({time.time() - t0:.0f}s elapsed) "
              "#####", flush=True)
        mod.run(csv_rows=rows, device=device, smoke=smoke)
    print("\n\nname,us_per_call,derived")
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived}")
    print(f"\ntotal wall time: {time.time() - t0:.0f}s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter, epilog=__doc__)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="each bench's CI-sized variant")
    ap.add_argument("bench", choices=[*MODULES, "all"])
    ap.add_argument("args", nargs=argparse.REMAINDER,
                    help="arguments of the bench's own command line")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    if args.bench == "all":
        if args.args:
            ap.error("'all' takes no bench arguments")
        run_all(args.device, args.smoke)
        return 0
    mod = _import(args.bench)
    if not args.args:
        mod.run(device=args.device, smoke=args.smoke)
        return 0
    return mod.main(args.args + ["--device", args.device]
                    + (["--smoke"] if args.smoke else []))


if __name__ == "__main__":
    sys.exit(main())
