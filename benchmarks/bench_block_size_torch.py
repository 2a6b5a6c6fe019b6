"""Fig. 8 in the port: the inference-time block-size sweep on a student
trained with a fixed block size (throughput rises with B; accuracy peaks at
the training block size), on the toy assets of ``common_torch``, as
``benchmarks/bench_block_size.py`` runs it, with its CSV names. Imports
nothing of JAX.

    python3 benchmarks/bench_block_size_torch.py            # the card
    python3 benchmarks/bench_block_size_torch.py --device cpu --smoke
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
    train_B = common.CDLM_CFG.block_size
    csv_rows = [] if csv_rows is None else csv_rows
    print(f"\n== Fig. 8 analog: inference block size (trained B={train_B}, "
          f"{dev}) ==")
    print(f"{'B':>4} {'TPS':>8} {'steps':>7} {'score':>6}")
    for B in (1, 2, 5, 10):
        if common.TASK.gen_len % B:
            continue
        r = common.eval_sampler(student, SAMPLERS["cdlm"], block_size=B)
        mark = " <- train B" if B == train_B else ""
        print(f"{B:>4} {r['tps']:>8.0f} {r['steps']:>7.1f} "
              f"{r['score']:>6.2f}{mark}")
        csv_rows.append((f"block_size/B{B}", r["latency_s"] * 1e6,
                         f"score={r['score']:.2f};steps={r['steps']:.1f}"))
    return csv_rows


def main(argv=None):
    args = common.make_parser(__doc__.split("\n")[0]).parse_args(argv)
    rows = run(device=args.device, smoke=args.smoke)
    common.write_results(args.json, [
        {"name": n, "us_per_call": us, "derived": d} for n, us, d in rows])
    return 0


if __name__ == "__main__":
    sys.exit(main())
