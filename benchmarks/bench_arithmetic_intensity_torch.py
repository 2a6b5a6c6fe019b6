"""Fig. 4 + App. B.4 in the port: the analytic arithmetic-intensity model
(``repro_torch.roofline``) with the paper's configurations (LLaMA-3.1-8B
AR, LLaDA-8B DLM) against the paper's A100-SXM4-80GB, the asserts of
``benchmarks/bench_arithmetic_intensity.py``, and an H100 column (the
port's card: its ridge and the attainable TFLOP/s at bs 1 and 128). Pure
analysis: it runs the same on the CPU and on the card, and imports nothing
of JAX.

    python3 benchmarks/bench_arithmetic_intensity_torch.py
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from benchmarks import common_torch as common  # noqa: E402
from repro_torch.configs import A100, H100  # noqa: E402
from repro_torch.roofline import (  # noqa: E402
    LLADA_8B,
    PAPER_TARGETS,
    attainable_tflops,
    blockwise_dlm_ai,
    paper_table,
)


def run(csv_rows=None, *, device=None, smoke=False):
    """The table, its asserts and the H100 column. ``device`` and ``smoke``
    are accepted for the runner's common surface and change nothing: the
    model is analytic."""
    print("\n== Fig. 4 / App. B.4: arithmetic intensity (analytic) ==")
    print(f"A100 ridge point: {A100.ridge_ai:.1f} FLOP/B (paper: 153.0)  |  "
          f"H100 ridge: {H100.ridge_ai:.1f}")
    rows = paper_table()
    print(f"{'bs':>4} {'AR':>8} {'vanilla':>9} {'B=4':>8} {'B=16':>8} "
          f"{'B=32':>8}   (AI, FLOP/byte)")
    for r in rows:
        print(f"{r['batch']:>4} {r['ar']:>8.1f} {r['vanilla']:>9.1f} "
              f"{r['block4']:>8.1f} {r['block16']:>8.1f} {r['block32']:>8.1f}")

    print("\nvs paper targets (bs where given):")
    r1 = {r["batch"]: r for r in rows}
    checks = []
    for (kind, bs), want in sorted(PAPER_TARGETS.items()):
        got = r1[bs][kind]
        dev = (got - want) / want * 100
        checks.append(abs(dev))
        print(f"  {kind:8s} bs={bs:<4d} ours={got:7.1f}  paper={want:7.1f} "
              f" ({dev:+.0f}%)")
        if csv_rows is not None:
            csv_rows.append((f"ai_model/{kind}_bs{bs}", 0.0,
                             f"ai={got:.1f};paper={want:.1f}"))
    print(f"  max |deviation| = {max(checks):.0f}% "
          "(accounting differences documented in roofline/ai_model.py)")

    # qualitative structure asserts (the paper's §5.4 claims), as in the
    # JAX bench, against the paper's A100
    assert r1[1]["ar"] < 2 < A100.ridge_ai, "AR must be memory-bound at bs=1"
    assert r1[1]["vanilla"] > A100.ridge_ai, \
        "vanilla DLM compute-bound at bs=1"
    assert r1[1]["ar"] < r1[1]["block32"] < r1[1]["vanilla"]
    # ridge crossing: B=32 crosses by bs~8, B=16 by bs~16 (paper's numbers)
    assert r1[8]["block32"] > A100.ridge_ai
    assert r1[16]["block16"] > A100.ridge_ai
    print("\nblock-wise (B=32) AI with fused unembed+select:")
    for bs in (1, 8, 32):
        dense = blockwise_dlm_ai(LLADA_8B, bs, 32)
        fused = blockwise_dlm_ai(LLADA_8B, bs, 32, fused_select=True)
        assert fused > dense, "fused select must strictly raise AI"
        print(f"  bs={bs:<4d} dense-lm_head={dense:7.1f}  "
              f"fused={fused:7.1f}  (x{fused / dense:.2f})")
        if csv_rows is not None:
            csv_rows.append((f"ai_model/block32_fused_bs{bs}", 0.0,
                             f"ai={fused:.1f};dense={dense:.1f}"))

    # roofline placement (App. B.4): attainable TFLOP/s on both cards
    for hw in (A100, H100):
        print(f"\nattainable TFLOP/s on {hw.name} (roofline, ridge "
              f"{hw.ridge_ai:.1f}):")
        for kind in ("ar", "vanilla", "block32"):
            at1 = attainable_tflops(r1[1][kind], hw)
            at128 = attainable_tflops(r1[128][kind], hw)
            print(f"  {kind:8s} bs=1: {at1:7.1f}   bs=128: {at128:7.1f}"
                  f"   (peak {hw.peak_flops / 1e12:.1f})")
            if csv_rows is not None and hw is H100:
                csv_rows.append((f"ai_model/h100_{kind}_tflops", 0.0,
                                 f"bs1={at1:.1f};bs128={at128:.1f};"
                                 f"ridge={hw.ridge_ai:.1f}"))
    return csv_rows


def main(argv=None):
    ap = common.make_parser(__doc__.split("\n")[0])
    ap.parse_args(argv)
    run()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
