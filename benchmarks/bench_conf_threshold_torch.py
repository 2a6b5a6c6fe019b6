"""Table 7 in the port: the token-confidence threshold sweep on the CDLM
student (speed must be monotone in tau; quality trades off at the
aggressive end), on the toy assets of ``common_torch``, as
``benchmarks/bench_conf_threshold.py`` runs it, with its assert and CSV
names. Imports nothing of JAX.

    python3 benchmarks/bench_conf_threshold_torch.py            # the card
    python3 benchmarks/bench_conf_threshold_torch.py --device cpu --smoke
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
    student = common.get_student(device=dev, smoke=smoke)
    csv_rows = [] if csv_rows is None else csv_rows
    print(f"\n== Table 7 analog: tau_conf sweep (CDLM student, {dev}) ==")
    print(f"{'tau':>6} {'TPS':>8} {'lat(ms)':>9} {'steps':>7} {'score':>6}")
    rows = []
    for tau in (0.95, 0.9, 0.85, 0.5):
        r = common.eval_sampler(student, SAMPLERS["cdlm"], conf_threshold=tau)
        rows.append((tau, r))
        print(f"{tau:>6.2f} {r['tps']:>8.0f} {r['latency_s']*1e3:>9.2f} "
              f"{r['steps']:>7.1f} {r['score']:>6.2f}")
        csv_rows.append((f"conf_threshold/tau{tau}", r["latency_s"] * 1e6,
                         f"score={r['score']:.2f};steps={r['steps']:.1f}"))
    steps = [r["steps"] for _, r in rows]
    assert steps == sorted(steps, reverse=True), \
        f"steps must decrease as tau drops: {steps}"
    return csv_rows


def main(argv=None):
    args = common.make_parser(__doc__.split("\n")[0]).parse_args(argv)
    rows = run(device=args.device, smoke=args.smoke)
    common.write_results(args.json, [
        {"name": n, "us_per_call": us, "derived": d} for n, us, d in rows])
    return 0


if __name__ == "__main__":
    sys.exit(main())
