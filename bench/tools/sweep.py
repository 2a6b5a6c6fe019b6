"""Runs of a cell without the recorder and the check (``correct`` is
null): the lanes sweep that set a mix's lanes, and the recorder-off side
of the recorder's cost. Each lanes value is a whole run of the cell, in
one process, with the mix's clients set to its lanes.

    python3 bench/tools/sweep.py --workload <name> --seed 7 --seconds 25
        [--lanes 8,16,32,64] [--out chiprun_out/x.jsonl]

Prints one line a run: the lanes, the end-to-end metrics, the window's
steps and the memory peak. Needs the card; the benchmark's own runs
never run this.
"""
import argparse
import copy
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--lanes", default="")
    p.add_argument("--out")
    args = p.parse_args(argv)
    t_start = time.perf_counter()
    for path in (ROOT / "bench", ROOT / "src"):
        sys.path.insert(0, str(path))
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    torch.set_num_threads(2)
    from harness import cell as CL
    from harness import spec as SP
    base = SP.load_cell(ROOT, args.workload).mix
    lanes = [int(n) for n in args.lanes.split(",") if n] or [None]
    out = open(args.out, "a") if args.out else None
    for n in lanes:
        mix = copy.deepcopy(base)
        if n is not None:
            mix["engine"]["lanes"] = mix["clients"] = n
        res = CL.run_cell(ROOT, args.workload, seed=args.seed,
                          seconds=args.seconds, trace=False, device="cuda",
                          t_start=t_start,
                          log=lambda m: print(m, file=sys.stderr),
                          record=False, mix=mix)
        line = {"workload": args.workload, "seed": args.seed,
                "lanes": mix["engine"]["lanes"],
                "metrics": {k: v["value"] for k, v in res["metrics"].items()},
                "memory_peak_bytes": res["device"]["memory_peak_bytes"],
                "correct": res["correct"]}
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
        torch.cuda.empty_cache()
        t_start = time.perf_counter()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
