"""The readings behind a cell's limits of ``correct``: the program's
numbers over many seeds and the control's (the reference in fp8 in the
program's place) over some, in one process, each seed a whole run of the
cell at its own size with a short window.

    python3 bench/tools/readings.py --workload <name> --seeds 1,2,3
        [--control-seeds 1,2,3] [--seconds 12] [--out chiprun_out/x.jsonl]

Prints a line per seed and, last, the largest program reading and the
smallest control reading of each number. The limits in
``bench/limits/<workload>.json`` are set from them (``PERF.md`` gives the
readings). Needs the card; the benchmark's own runs never run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
NUMBERS = ("choice_gap", "token_gap", "order_gap", "unfinished")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=12.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    for path in (ROOT / "bench", ROOT / "src"):
        sys.path.insert(0, str(path))
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from harness import cell as CL
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    program, low = {n: [] for n in NUMBERS}, {n: [] for n in NUMBERS}
    out = open(args.out, "a") if args.out else None
    for seed in seeds:
        t = time.perf_counter()
        res = CL.run_cell(ROOT, args.workload, seed=seed,
                          seconds=args.seconds, trace=False, device="cuda",
                          t_start=t, log=lambda m: print(m, file=sys.stderr),
                          readings=True, control=seed in control)
        line = {"workload": args.workload, "seed": seed,
                "correct": res["correct"],
                "program": {n: res["numbers"][n] for n in NUMBERS},
                "control": {n: res["control"][n] for n in NUMBERS}
                if "control" in res else None,
                "judged_tokens": (res.get("control") or {}).get(
                    "judged_tokens"),
                "tokens_per_s": res["metrics"]["tokens_per_s"]["value"],
                "seconds": time.perf_counter() - t}
        for n in NUMBERS:
            program[n].append(line["program"][n])
            if line["control"]:
                low[n].append(line["control"][n])
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
        torch.cuda.empty_cache()
    summary = {"workload": args.workload, "seeds": len(seeds),
               "program_max": {n: max(v) for n, v in program.items()},
               "control_min": {n: min(v) for n, v in low.items() if v}}
    print(json.dumps(summary), flush=True)
    if out:
        out.write(json.dumps(summary) + "\n")
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
