"""Render the dry-run's markdown tables from its JSON records, the
counterpart of the JAX package's ``roofline/report.py`` (the same tables,
read from the port's ``experiments/dryrun_torch/``).

    PYTHONPATH=src python -m repro_torch.roofline.report
"""
from __future__ import annotations

import json
import os
from typing import List

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
BASE = os.path.join("experiments", "dryrun_torch")


def _fmt_s(x: float) -> str:
    if x >= 1.0:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.1f}ms"
    return f"{x*1e6:.0f}us"


def _fmt_b(x: float) -> str:
    for unit, div in (("GiB", 2**30), ("MiB", 2**20), ("KiB", 2**10)):
        if x >= div:
            return f"{x/div:.1f}{unit}"
    return f"{x:.0f}B"


def load(path: str) -> List[dict]:
    with open(path) as f:
        return json.load(f)


def roofline_table(recs: List[dict]) -> str:
    lines = [
        "| arch | shape | FLOPs/chip | B/chip | coll B/chip | compute | "
        "memory | collective | bound | useful | mem/chip |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    recs = sorted([r for r in recs if r.get("status") == "ok"],
                  key=lambda r: (r["arch"], SHAPE_ORDER.index(r["shape"])))
    for r in recs:
        mem = r.get("memory_analysis") or {}
        tot = (mem.get("temp_bytes", 0) + mem.get("argument_bytes", 0))
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['hlo_flops']:.2e} | "
            f"{r['hlo_bytes']:.2e} | {r['coll_bytes']:.2e} | "
            f"{_fmt_s(r['compute_s'])} | {_fmt_s(r['memory_s'])} | "
            f"{_fmt_s(r['collective_s'])} | **{r['bottleneck']}** | "
            f"{r['useful_ratio']:.2f} | {_fmt_b(tot)} |")
    for r in [x for x in recs if x.get("status") == "skipped"]:
        lines.append(f"| {r['arch']} | {r['shape']} | skipped | | | | | | | | |")
    return "\n".join(lines)


def dryrun_table(recs: List[dict]) -> str:
    lines = [
        "| arch | shape | status | lower | compile | collective schedule |",
        "|---|---|---|---|---|---|",
    ]
    for r in sorted(recs, key=lambda r: (r["arch"],
                                         SHAPE_ORDER.index(r["shape"]))):
        if r.get("status") == "ok":
            cs = r["coll_detail"]["counts"]
            sched = " ".join(f"{k}×{v}" for k, v in sorted(cs.items()))
            lines.append(f"| {r['arch']} | {r['shape']} | ok | "
                         f"{r['lower_s']:.0f}s | {r['compile_s']:.0f}s | "
                         f"{sched} |")
        elif r.get("status") == "skipped":
            lines.append(f"| {r['arch']} | {r['shape']} | SKIP | | | "
                         f"{r['reason'][:80]} |")
        else:
            lines.append(f"| {r['arch']} | {r['shape']} | ERROR | | | "
                         f"{r.get('error', '')[:80]} |")
    return "\n".join(lines)


def main(base: str = BASE):
    single = load(os.path.join(base, "dryrun.json"))
    print("## Single-pod (16×16 = 256 chips) roofline, H100 constants, "
          "counted on the meta device\n")
    print(roofline_table(single))
    print("\n\n## Single-pod dry-run\n")
    print(dryrun_table(single))
    mp_path = os.path.join(base, "dryrun_multipod.json")
    if os.path.exists(mp_path):
        multi = load(mp_path)
        print("\n\n## Multi-pod (2×16×16 = 512 chips) dry-run\n")
        print(dryrun_table(multi))


if __name__ == "__main__":
    main()
