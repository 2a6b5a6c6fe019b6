"""The hillclimb's named dry-run variants, counted on the meta device: the
counterpart of the JAX package's ``launch/perf.py``, its ten ``VARIANTS``
unchanged, each through ``dryrun.run_one`` and
``dryrun.extrapolate_record``.

    PYTHONPATH=src python -m repro_torch.launch.perf [--only tag]

Records go to experiments/dryrun_torch/perf.json. Variants that differ only
in the reference's compiler-side fixes (``*_slicefix``, ``*_headfix``,
``*_tpfsdp_fix``, ``*_capfix`` name code changes of the JAX package, not
flags) are the same step here: the three of ``ALIASES`` take their twin's
record (``alias_of``) instead of counting it again.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from repro_torch.launch.dryrun import OUT_DIR, extrapolate_record, run_one

# (tag, arch, shape, run_one kwargs)
VARIANTS = [
    # H1: worst useful ratio + the paper's own training step
    ("h1_train_slicefix", "qwen2-0.5b", "train_4k", {}),
    ("h1_train_efficient_loss", "qwen2-0.5b", "train_4k",
     {"efficient_loss": True}),
    # H2: most collective-bound decode (MoE all-to-all)
    ("h2_kimi_decode_slicefix", "kimi-k2-1t-a32b", "decode_32k", {}),
    ("h2_kimi_decode_seqpar", "kimi-k2-1t-a32b", "decode_32k",
     {"seq_parallel_decode": True}),
    ("h1_train_headfix", "qwen2-0.5b", "train_4k",
     {"efficient_loss": True}),
    ("h1_train_tpfsdp_fix", "qwen2-0.5b", "train_4k",
     {"efficient_loss": True}),
    ("h1b_110b_train_tpfsdp", "qwen1.5-110b", "train_4k",
     {"efficient_loss": True}),
    ("h2_kimi_decode_capfix", "kimi-k2-1t-a32b", "decode_32k", {}),
    # H3: long-context decode, the sequence-parallel cache
    ("h3_110b_long_slicefix", "qwen1.5-110b", "long_500k", {}),
    ("h3_110b_long_seqpar", "qwen1.5-110b", "long_500k",
     {"seq_parallel_decode": True}),
]

# tags whose step is an earlier tag's, the same (arch, shape, kwargs)
ALIASES = {"h1_train_headfix": "h1_train_efficient_loss",
           "h1_train_tpfsdp_fix": "h1_train_efficient_loss",
           "h2_kimi_decode_capfix": "h2_kimi_decode_slicefix"}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None)
    args = ap.parse_args(argv)
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, "perf.json")
    results = {}
    if os.path.exists(path):
        with open(path) as f:
            results = json.load(f)
    for tag, arch, shape, kw in VARIANTS:
        if args.only and args.only not in tag:
            continue
        if tag in results:
            print(f"[{tag}] cached")
            continue
        twin = results.get(ALIASES.get(tag))
        if twin is not None:
            results[tag] = dict(twin, tag=tag, alias_of=ALIASES[tag])
            print(f"[{tag}] = [{ALIASES[tag]}]")
            _save(results, path)
            continue
        t0 = time.perf_counter()
        try:
            rec = run_one(arch, shape, verbose=False, **kw)
            extrapolate_record(rec, seq_parallel_decode=kw.get(
                "seq_parallel_decode", False),
                efficient_loss=kw.get("efficient_loss", False))
            rec["tag"] = tag
            rec["variant_kwargs"] = kw
            results[tag] = rec
            print(f"[{tag}] ({time.perf_counter() - t0:.0f}s) "
                  f"compute={rec['compute_s'] * 1e3:.1f}ms "
                  f"memory={rec['memory_s'] * 1e3:.1f}ms "
                  f"collective={rec['collective_s'] * 1e3:.1f}ms "
                  f"-> {rec['bottleneck']}-bound "
                  f"useful={rec['useful_ratio']:.2f}")
            for op in rec["coll_detail"]["top_ops"][:3]:
                print(f"    top-coll: {op['kind']} "
                      f"{op['bytes'] / 2**20:.1f}MiB {op['shape']}")
        except Exception as e:
            print(f"[{tag}] FAILED: {type(e).__name__}: {e}")
            traceback.print_exc()
        _save(results, path)
    return 0


def _save(results, path):
    with open(path, "w") as f:
        json.dump(results, f, indent=1, default=str)


if __name__ == "__main__":
    raise SystemExit(main())
