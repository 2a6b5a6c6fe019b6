"""Table 3 in the port: the loss-weight composition ablation. Short CDLM
students are trained under different (w_distill, w_cons, w_dlm), each
cached under its own name, and scored with their refinement steps, on the
toy assets of ``common_torch``, as ``benchmarks/bench_loss_weights.py``
runs it, with its assert and CSV names: consistency-only must not beat
distill+consistency. Imports nothing of JAX.

    python3 benchmarks/bench_loss_weights_torch.py            # the card
    python3 benchmarks/bench_loss_weights_torch.py --device cpu --smoke
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from benchmarks import common_torch as common  # noqa: E402
from repro_torch import resolve_device  # noqa: E402
from repro_torch.core.sampler import SAMPLERS  # noqa: E402

VARIANTS = [
    ("distill-only", (1.0, 0.0, 0.01)),
    ("consistency-only", (0.0, 1.0, 0.01)),
    ("distill+cons", (1.0, 0.5, 0.01)),
    ("no-dlm", (1.0, 0.5, 0.0)),
]


def run(csv_rows=None, *, device="cuda", smoke=False, steps=250):
    dev = resolve_device(device)
    teacher = common.get_teacher(dev, smoke)
    dataset = common.get_dataset(teacher, smoke)
    csv_rows = [] if csv_rows is None else csv_rows
    print(f"\n== Table 3 analog: loss-weight ablation ({dev}) ==")
    print(f"{'variant':18s} {'(wd,wc,wm)':>16} {'score':>6} {'steps':>7}")
    results = {}
    for name, w in VARIANTS:
        student = common.get_student(
            teacher, dataset, device=dev, smoke=smoke, weights=w, steps=steps,
            cache_name=f"student_w{w[0]}_{w[1]}_{w[2]}.npz")
        r = common.eval_sampler(student, SAMPLERS["cdlm"], conf_threshold=0.9)
        results[name] = r
        print(f"{name:18s} {str(w):>16} {r['score']:>6.2f} "
              f"{r['steps']:>7.1f}")
        csv_rows.append((f"loss_weights/{name}", r["latency_s"] * 1e6,
                         f"score={r['score']:.2f};steps={r['steps']:.1f}"))
    # paper row 2: consistency-only collapses
    assert results["consistency-only"]["score"] <= \
        results["distill+cons"]["score"], "consistency-only should not win"
    return csv_rows


def main(argv=None):
    args = common.make_parser(__doc__.split("\n")[0]).parse_args(argv)
    rows = run(device=args.device, smoke=args.smoke)
    common.write_results(args.json, [
        {"name": n, "us_per_call": us, "derived": d} for n, us, d in rows])
    return 0


if __name__ == "__main__":
    sys.exit(main())
