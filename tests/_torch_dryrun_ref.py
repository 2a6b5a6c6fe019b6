"""The JAX package's dry-run at a 2x4 mesh of 8 forced host devices, for
``tests/test_torch_dryrun.py``: for each case of ``argv[1]`` (a JSON list
of [arch, shape, shape kind, seq_len, batch, config overrides, plan
kwargs]; the config is the registry's ``reduced()``), ``run_one`` and
``extrapolate_record`` as the reference runs them, and the collectives of
the depth-1 and depth-2 compiles that ``extrapolate_record`` parses,
counted per (kind, mesh axes of the group, tensor shape). Prints one JSON
list: per case the extrapolated FLOPs per chip, the collective bytes and
wire bytes, and the per-period and base collective counts."""
import json
import re
import sys

import jax
import numpy as np

jax.devices()     # the backend starts at the caller's 8 devices, before
import repro.configs.base as B  # noqa: E402  dryrun's import asks for 512
import repro.launch.dryrun as D  # noqa: E402
import repro.launch.specs as S  # noqa: E402
import repro.roofline.hlo as H  # noqa: E402
from repro.configs.registry import get_config  # noqa: E402
from repro.launch.mesh import make_tiny_mesh  # noqa: E402

mesh = make_tiny_mesh(data=2, model=4)
D.make_production_mesh = lambda multi_pod=False: mesh
coord = {d.id: pos for pos, d in np.ndenumerate(mesh.devices)}
texts = []
parse = H.collective_bytes


def spy(text, top_n=8):
    """``extrapolate_record``'s parser, keeping the HLO it parses."""
    texts.append(text)
    return parse(text, top_n)


H.collective_bytes = spy


def groups(line):
    """The device groups of a collective's HLO line."""
    if "source_target_pairs=" in line:
        tail = line.split("source_target_pairs=")[1]
        return [[int(a), int(b)] for a, b in
                re.findall(r"\{(\d+),(\d+)\}", tail.split("}}")[0] + "}")]
    m = re.search(r"replica_groups=\[(\d+),(\d+)\]<=\[([\d,]+)\]"
                  r"(?:T\(([\d,]+)\))?", line)
    if m:
        dims = [int(x) for x in m.group(3).split(",")]
        ids = np.arange(int(np.prod(dims))).reshape(dims)
        if m.group(4):
            ids = ids.transpose([int(x) for x in m.group(4).split(",")])
        return ids.reshape(int(m.group(1)), int(m.group(2))).tolist()
    m = re.search(r"replica_groups=\{((?:\{[\d,]*\},?)*)\}", line)
    gs = [[int(x) for x in g.split(",") if x]
          for g in re.findall(r"\{([\d,]*)\}", m.group(1))] if m else []
    return gs or [sorted(coord)]


def axes(gs):
    """The mesh axes along which a group's devices differ."""
    return ",".join(a for i, a in enumerate(mesh.axis_names)
                    if any(len({coord[d][i] for d in g}) > 1 for g in gs))


def ops(text):
    """(kind|axes|shape) -> count, one per tensor of a tuple op."""
    out = {}
    for line in text.splitlines():
        m = H._OP_RE.search(line)
        if not m or "-done(" in line:
            continue
        shapes = (H._SHAPE_RE.findall(m.group(1)) if m.group(1) is not None
                  else [(m.group(2), m.group(3))])
        ax = axes(groups(line))
        for dt, dims in shapes:
            key = f"{m.group(4)}|{ax}|{dt}[{dims}]"
            out[key] = out.get(key, 0) + 1
    return out


res = []
for arch, shape, n, L, b, ovr, kw in json.loads(sys.argv[1]):
    cfg = get_config(arch).reduced(**ovr)
    S.get_config = D.get_config = lambda a, cfg=cfg: cfg
    B.INPUT_SHAPES[shape] = B.ShapeConfig(shape, L, b, n)
    rec = D.run_one(arch, shape, verbose=False, **kw)
    D.extrapolate_record(rec, **kw)
    o1, o2 = ops(texts[-2]), ops(texts[-1])
    ex = rec["extrapolated"]
    res.append({"flops": rec["hlo_flops"], "coll_total": rec["coll_bytes"],
                "coll_wire": ex["base"]["coll_wire"]
                + ex["per_period"]["coll_wire"] * (ex["n_periods"] - 1),
                "per_period": {k: o2.get(k, 0) - o1.get(k, 0)
                               for k in set(o1) | set(o2)
                               if o2.get(k, 0) != o1.get(k, 0)},
                "base": o1})
print(json.dumps(res))
