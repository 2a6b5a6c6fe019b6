"""Dry-run of every (arch x input shape x mesh) step, counted on the meta
device: the counterpart of the JAX package's ``launch/dryrun.py``.

Each step of ``launch/specs.py`` runs once on meta tensors under
``roofline/analysis.py::MetaCounter`` (FLOPs, unfused bytes, the peak of
live bytes), its collectives are listed from its sharding specs, and the
three-term roofline is taken with the H100's constants
(``configs.base.H100``), its collectives priced on DGX H100-class nodes
(``configs.base.DGX_H100``, ``collective_links`` in the record): no card
is needed. The record keeps the reference's keys
(``RooflineReport.to_dict()`` and ``status``, ``meta``,
``memory_analysis``, ``lower_s``: seconds to build the plan,
``compile_s``: seconds to count it), so ``roofline/report.py`` renders
either package's records.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k
  python -m repro_torch.launch.dryrun --arch all --shape all [--multi-pod]
  python -m repro_torch.launch.dryrun ... --seq-parallel-decode
  python -m repro_torch.launch.dryrun ... --extrapolate
Records go to experiments/dryrun_torch/<tag>.json. ``--extrapolate``
counts the depth-1 and depth-2 variants of the existing ``ok`` records
and records them beside the full-depth count (``extrapolated``): an eager
count sees every layer, so the reference's linear extrapolation is a check
here, and ``linear`` says whether it holds (FLOPs, bytes, collective
bytes within 1e-9).
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.configs.registry import ARCHITECTURES, get_config
from repro_torch.launch.mesh import make_production_mesh, n_chips
from repro_torch.launch.specs import SkipPair, build_plan
from repro_torch.roofline import analysis as A
from repro_torch.roofline.collectives import collective_bytes

OUT_DIR = os.path.join("experiments", "dryrun_torch")
LINEAR_RTOL = 1e-9


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            fsdp: bool = True, seq_parallel_decode: bool = False,
            efficient_loss: bool = False, verbose: bool = True, mesh=None):
    """The record of one pair (``SkipPair`` raises through); ``mesh``
    replaces the production mesh (``chip_smoke.py`` counts at 1x1)."""
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    cfg = get_config(arch)
    t0 = time.perf_counter()
    plan = build_plan(arch, shape_name, mesh, fsdp=fsdp,
                      seq_parallel_decode=seq_parallel_decode,
                      efficient_loss=efficient_loss)
    t_lower = time.perf_counter() - t0
    counts = A.count(plan)
    mem = A.memory_analysis(plan, counts, mesh)
    report = A.analyze(plan, counts, cfg=cfg, shape_name=shape_name,
                       mesh_name=mesh.name, chips=n_chips(mesh),
                       tokens=plan.meta["tokens"], kind=plan.meta["kind"],
                       memory=mem)
    rec = report.to_dict()
    rec.update({"status": "ok", "lower_s": t_lower,
                "compile_s": counts["seconds"], "memory_analysis": mem,
                "meta": plan.meta, "fsdp": fsdp,
                "seq_parallel_decode": seq_parallel_decode,
                "collective_links": {
                    "fabric": A.DGX_H100.name,
                    "by_axes": A.collective_seconds(plan.collectives,
                                                    mesh)[1]},
                "counted": {"device": "meta", "ops": counts["ops"],
                            "flops": counts["flops"],
                            "bytes": counts["bytes"],
                            "peak_bytes": counts["peak_bytes"],
                            "depth": "full"}})
    if verbose:
        print(f"[{arch} × {shape_name} × {mesh.name}] OK  "
              f"plan={t_lower:.1f}s count={counts['seconds']:.1f}s "
              f"({counts['ops']} ops)")
        print(f"  memory_analysis/chip: "
              f"temp={mem['temp_bytes'] / 2**30:.2f}GiB "
              f"args={mem['argument_bytes'] / 2**30:.2f}GiB "
              "(HBM/chip: 80GB)")
        print(f"  counted: {rec['hlo_flops']:.3e} FLOPs, "
              f"{rec['hlo_bytes']:.3e} B accessed, "
              f"{rec['coll_bytes']:.3e} B collectives "
              f"{rec['coll_detail']['counts']} (per chip)")
        print(f"  roofline terms/chip (H100): "
              f"compute={rec['compute_s'] * 1e3:.2f}ms "
              f"memory={rec['memory_s'] * 1e3:.2f}ms "
              f"collective={rec['collective_s'] * 1e3:.2f}ms "
              f"-> {rec['bottleneck']}-bound; "
              f"useful={rec['useful_ratio']:.2f}")
    return rec


def _cost_of(arch, shape_name, mesh, k, **kw):
    plan = build_plan(arch, shape_name, mesh, roofline_periods=k, **kw)
    counts = A.count(plan)
    coll = collective_bytes(plan.collectives)
    return {"flops": counts["flops"], "bytes": counts["bytes"],
            "coll_wire": coll["wire_bytes"],
            "coll_total": coll["total_bytes"]}


def extrapolate_record(rec, *, multi_pod=False, fsdp=True,
                       seq_parallel_decode=False, efficient_loss=False,
                       mesh=None):
    """Count the depth-1 and depth-2 variants of ``rec``'s step and record
    the linear extrapolation to the full period count beside the
    full-depth count it must equal (``rec["extrapolated"]``). The record's
    own terms stay the full-depth count's."""
    arch = rec["arch"]
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    kw = dict(fsdp=fsdp, seq_parallel_decode=seq_parallel_decode,
              efficient_loss=efficient_loss)
    c1 = _cost_of(arch, rec["shape"], mesh, 1, **kw)
    c2 = _cost_of(arch, rec["shape"], mesh, 2, **kw)
    n = get_config(arch).n_periods
    ex = {key: c1[key] + (c2[key] - c1[key]) * (n - 1) for key in c1}
    chips = rec["chips"]
    full = {"flops": rec["hlo_flops"] * chips,
            "bytes": rec["hlo_bytes"] * chips,
            "coll_wire": rec["coll_detail"]["wire_bytes"],
            "coll_total": rec["coll_bytes"]}
    linear = all(abs(ex[k] - full[k]) <= LINEAR_RTOL * max(abs(full[k]), 1)
                 for k in full)
    rec["extrapolated"] = {"per_period": {k: c2[k] - c1[k] for k in c1},
                           "base": c1, "n_periods": n, "extrapolated": ex,
                           "full_depth": full, "linear": linear,
                           "note": "depth-1/2 variants, linear in periods, "
                                   "against the full-depth count"}
    return rec


def _load(path):
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return []


def _dump(results, path):
    with open(path, "w") as f:
        json.dump(results, f, indent=1, default=str)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--seq-parallel-decode", action="store_true")
    ap.add_argument("--efficient-loss", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--extrapolate", action="store_true",
                    help="count depth-1/2 variants of existing records and "
                         "check the full-depth count against their linear "
                         "extrapolation")
    args = ap.parse_args(argv)

    archs = list(ARCHITECTURES) if args.arch == "all" else [args.arch]
    shapes = list(INPUT_SHAPES) if args.shape == "all" else [args.shape]
    tag = args.out or ("dryrun_multipod" if args.multi_pod else "dryrun")
    path = os.path.join(OUT_DIR, f"{tag}.json")
    os.makedirs(OUT_DIR, exist_ok=True)
    results = _load(path)

    if args.extrapolate:
        for rec in results:
            if (rec.get("status") != "ok" or rec["arch"] not in archs
                    or rec["shape"] not in shapes or "extrapolated" in rec
                    or rec.get("seq_parallel_decode", False)
                    != args.seq_parallel_decode):
                continue
            t0 = time.perf_counter()
            try:
                extrapolate_record(rec, multi_pod=args.multi_pod,
                                   fsdp=not args.no_fsdp,
                                   seq_parallel_decode=args.seq_parallel_decode,
                                   efficient_loss=args.efficient_loss)
                print(f"[{rec['arch']} × {rec['shape']}] extrapolated "
                      f"({time.perf_counter() - t0:.0f}s): linear="
                      f"{rec['extrapolated']['linear']}")
            except Exception as e:
                print(f"[{rec['arch']} × {rec['shape']}] extrapolation "
                      f"failed: {type(e).__name__}: {e}")
            _dump(results, path)
        return 0

    have = {(r["arch"], r["shape"], r.get("seq_parallel_decode", False),
             r.get("fsdp", True)) for r in results if r.get("status") == "ok"}
    for arch in archs:
        for shape in shapes:
            key = (arch, shape, args.seq_parallel_decode, not args.no_fsdp)
            if key in have:
                print(f"[{arch} × {shape}] cached, skip")
                continue
            try:
                rec = run_one(arch, shape, multi_pod=args.multi_pod,
                              fsdp=not args.no_fsdp,
                              seq_parallel_decode=args.seq_parallel_decode,
                              efficient_loss=args.efficient_loss)
            except SkipPair as e:
                rec = {"arch": arch, "shape": shape, "status": "skipped",
                       "reason": str(e)}
                print(f"[{arch} × {shape}] SKIP: {e}")
            except Exception as e:
                rec = {"arch": arch, "shape": shape, "status": "error",
                       "error": f"{type(e).__name__}: {e}",
                       "trace": traceback.format_exc()[-2000:]}
                print(f"[{arch} × {shape}] ERROR: {type(e).__name__}: {e}")
            results = _load(path)
            results = [r for r in results
                       if not (r["arch"] == arch and r["shape"] == shape
                               and r.get("seq_parallel_decode", False)
                               == args.seq_parallel_decode
                               and r.get("fsdp", True) == (not args.no_fsdp))]
            results.append(rec)
            _dump(results, path)
    n_ok = sum(1 for r in results if r.get("status") == "ok")
    print(f"\n{n_ok}/{len(results)} OK -> {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
