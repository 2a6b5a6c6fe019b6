"""Table 4 in the port: naively truncating the teacher's step budget
(threshold-0 parallel finalization, ~1 step a block) against CDLM at a
comparable budget, on the toy assets of ``common_torch`` (trained on the
device and cached), as ``benchmarks/bench_step_truncation.py`` runs it,
with its assert and CSV names. Imports nothing of JAX.

    python3 benchmarks/bench_step_truncation_torch.py            # the card
    python3 benchmarks/bench_step_truncation_torch.py --device cpu --smoke
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from benchmarks import common_torch as common  # noqa: E402
from repro_torch import resolve_device  # noqa: E402
from repro_torch.core.sampler import SAMPLERS  # noqa: E402


def run(csv_rows=None, *, device="cuda", smoke=False):
    dev = resolve_device(device)
    teacher = common.get_teacher(dev, smoke)
    student = common.get_student(teacher, device=dev, smoke=smoke)

    full = common.eval_sampler(teacher, SAMPLERS["vanilla"])
    trunc = common.eval_sampler(teacher, SAMPLERS["fast_dllm"],
                                conf_threshold=0.0)
    ours = common.eval_sampler(student, SAMPLERS["cdlm"], conf_threshold=0.9)

    csv_rows = [] if csv_rows is None else csv_rows
    print(f"\n== Table 4 analog: step truncation ({dev}) ==")
    print(f"{'method':28s} {'steps':>7} {'lat(ms)':>9} {'score':>6}")
    for name, r in [("teacher full budget", full),
                    ("teacher truncated (naive)", trunc),
                    ("CDLM student", ours)]:
        print(f"{name:28s} {r['steps']:>7.1f} {r['latency_s']*1e3:>9.2f} "
              f"{r['score']:>6.2f}")
        csv_rows.append((f"step_truncation/{name.replace(' ', '_')}",
                         r["latency_s"] * 1e6,
                         f"score={r['score']:.2f};steps={r['steps']:.1f}"))
    assert trunc["score"] <= full["score"], "truncation should hurt"
    return csv_rows


def main(argv=None):
    args = common.make_parser(__doc__.split("\n")[0]).parse_args(argv)
    rows = run(device=args.device, smoke=args.smoke)
    common.write_results(args.json, [
        {"name": n, "us_per_call": us, "derived": d} for n, us, d in rows])
    return 0


if __name__ == "__main__":
    sys.exit(main())
