"""The collectives of a dry-run step, listed from its sharding specs: the
counterpart of the JAX package's ``roofline/hlo.py``.

The reference parses XLA's partitioned HLO for ``all-gather``,
``all-reduce``, ``reduce-scatter``, ``all-to-all`` and
``collective-permute`` ops and sums their per-chip output bytes. PyTorch
has no SPMD partitioner, so there is no HLO: the step's collectives are
those of the Megatron tensor-parallel, FSDP program its specs describe
(``parallel/sharding.py``), each ``(kind, bytes, shape, axes)`` with
``bytes`` the per-chip output size, ``shape`` spelled as HLO spells it
(``"bf16[4096,896]"``) and ``axes`` the mesh axes its group spans. A
parameter stacked over a slot's periods is one op per layer, as a
per-layer FSDP unit gathers it:

- the FSDP all-gather of each parameter sharded over a batch axis
  (``data``, ``pod``), its output the layer's slice less its ``model``
  shards: once per forward pass and once per backward pass (a remat
  recompute runs on the backward's gather);
- in training, a reduce-scatter of each such leaf's gradient (its fully
  sharded size), and an all-reduce of every other leaf's gradient over
  the batch axes where the batch is sharded;
- the row-parallel all-reduce of the ``(b, L, d)`` activation after each
  output projection whose contraction dim is sharded over ``model``
  (attention and cross attention ``wo``, ``mlp/wo``, the shared expert's
  ``wo``, Mamba's ``out_proj``, RWKV's ``wo`` and channel mix ``wv``):
  per layer and pass, where a training step's passes are its forwards,
  their remat recomputes and its backwards (the backward's all-reduce is
  the column-parallel input's gradient);
- the MoE dispatch and combine all-to-all (``T k`` rows of ``d`` a layer
  and pass) where the experts are sharded;
- per attention layer of a decode step on a sequence-sharded cache, the
  sequence-parallel decode's three partial merges (``acc``, ``m``, ``l``)
  and the gathers of its head-sharded ``q`` and block K/V (the reference's
  ``shard_map`` takes ``q`` whole on every shard), or, read without it,
  the all-gather of the layer's K and V.

This is not what XLA's partitioner issues for the same specs, which
chooses per op and reshards where it must; ``tests/test_torch_dryrun.py``
holds the list against the reference's compiled HLO at a 2x4 mesh and
PERF.md names the divergences. :func:`collective_bytes` returns the
reference's record.
"""
from __future__ import annotations

import math
import re
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

from repro_torch import tree as T
from repro_torch.configs.base import ATTN, ATTN_LOCAL
from repro_torch.parallel import sharding as SH

# (kind, per-chip output bytes, HLO shape, mesh axes of the group)
Op = Tuple[str, int, str, Tuple[str, ...]]

DTYPE_NAMES = {torch.float64: "f64", torch.float32: "f32",
               torch.bfloat16: "bf16", torch.float16: "f16",
               torch.int64: "s64", torch.int32: "s32", torch.int16: "s16",
               torch.int8: "s8", torch.uint8: "u8", torch.bool: "pred"}

FSDP_AXES = ("pod", "data")
MODEL = ("model",)
# output projections whose contraction dim a "tp"/"tp_fsdp" rule shards
ROW_PARALLEL = re.compile(r"((attn|cross|mlp)/wo|moe/shared/wo|"
                          r"mamba/out_proj|rwkv_tm/wo|rwkv_cm/wv)$")


def op(kind: str, dtype: torch.dtype, shape, axes=MODEL) -> Op:
    shape = tuple(int(s) for s in shape)
    nbytes = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
    return (kind, nbytes,
            f"{DTYPE_NAMES[dtype]}[{','.join(str(s) for s in shape)}]",
            tuple(axes))


def _local(shape, spec, mesh, keep=()):
    """``shape`` cut by every axis of ``spec`` but those in ``keep``."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for n, ax in zip(shape, spec):
        names = ax if isinstance(ax, tuple) else (() if ax is None else (ax,))
        out.append(n // math.prod(mesh.shape[a] for a in names
                                  if a not in keep))
    return out


def _in_mesh_order(axes, mesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a in axes)


def param_ops(params, mesh, *, fsdp: bool, gathers: int, grads: bool,
              batch_axes) -> List[Op]:
    """FSDP all-gathers, ``gathers`` per layer (a step's forward and
    backward passes), and with ``grads`` the gradients' reduce-scatters
    and, over ``batch_axes`` (the batch's mesh axes, or None), the
    all-reduces of the leaves FSDP does not shard."""
    b_axes = (() if batch_axes is None else
              _in_mesh_order(SH.spec_axes((batch_axes,)), mesh))
    ops = []
    for path, leaf in T.leaves_with_path(params):
        spec = SH.leaf_spec(path, leaf, mesh, fsdp=fsdp)
        layers, shape, spec_l = 1, tuple(leaf.shape), tuple(spec)
        if "slots/" in T.key_path(path):      # stacked over periods
            layers, shape, spec_l = shape[0], shape[1:], spec_l[1:]
        gathered = _in_mesh_order(SH.spec_axes(spec) & set(FSDP_AXES),
                                  mesh)
        if gathered:
            full = _local(shape, spec_l, mesh, keep=gathered)
            ops += [op("all-gather", leaf.dtype, full, gathered)] * (
                gathers * layers)
        if grads and gathered:
            ops += [op("reduce-scatter", leaf.dtype,
                       _local(shape, spec_l, mesh), gathered)] * layers
        elif grads and b_axes:
            ops += [op("all-reduce", leaf.dtype,
                       _local(shape, spec_l, mesh), b_axes)] * layers
    return ops


def activation_ops(params, mesh, cfg, *, rows: int, seq_len: int,
                   passes: int, dtype: torch.dtype,
                   enc_len: int = 0) -> List[Op]:
    """Row-parallel all-reduces of the ``(rows, L, d)`` activation and MoE
    all-to-alls, ``passes`` times per layer (see the module's docstring);
    ``rows`` is the batch a chip holds. The encoder's layers run over
    ``enc_len`` rows."""
    ops = []
    d = cfg.d_model
    for path, leaf in T.leaves_with_path(params):
        name = T.key_path(path)
        spec = SH.leaf_spec(path, leaf, mesh)
        layers = leaf.shape[0]
        L = enc_len if name.startswith("encoder/") else seq_len
        if L == 0:
            continue
        if ROW_PARALLEL.search(name) and "model" in SH.spec_axes(
                spec[-2:-1]):
            ops += [op("all-reduce", dtype, (rows, L, d))] * (
                layers * passes)
        if name.endswith("moe/wi_gate") and "model" in SH.spec_axes(
                spec[-3:-2]):
            k = cfg.experts_per_token
            ops += [op("all-to-all", dtype, (rows * L * k, d))] * (
                2 * layers * passes)
    return ops


def decode_ops(cfg, *, rows: int, Bq: int, S: int, dtype: torch.dtype,
               seq_parallel: bool, q_sharded: bool = False,
               kv_sharded: bool = False) -> List[Op]:
    """Per attention layer of a decode step on a sequence-sharded cache:
    the sequence-parallel decode's merges of ``acc``, ``m`` and ``l`` and
    the gathers of ``q`` (``q_sharded``: its heads are sharded over
    ``model``) and of the block's K and V (``kv_sharded``), or the
    all-gather of K and V."""
    n_attn = sum(1 for mix, _ in cfg.layer_period
                 if mix in (ATTN, ATTN_LOCAL)) * cfg.n_periods
    Kv, G, hd = cfg.n_kv_heads, cfg.q_per_kv, cfg.head_dim
    if seq_parallel:
        per = [op("all-reduce", torch.float32, (rows, Kv, Bq * G, hd)),
               op("all-reduce", torch.float32, (rows, Kv, Bq * G, 1)),
               op("all-reduce", torch.float32, (rows, Kv, Bq * G, 1))]
        if q_sharded:
            per.append(op("all-gather", dtype, (rows, Bq, Kv * G, hd)))
        if kv_sharded:
            per += [op("all-gather", dtype, (rows, Bq, Kv, hd))] * 2
    else:
        per = [op("all-gather", dtype, (rows, S, Kv, hd))] * 2
    return per * n_attn


def collective_bytes(ops, top_n: int = 8) -> Dict[str, float]:
    """The reference's record of a step's collectives: output bytes summed
    per kind, counts per kind, the total, the wire bytes (all-reduce
    counted twice, a ring's traffic) and the ``top_n`` largest ops."""
    out = defaultdict(float)
    count = defaultdict(int)
    listed = []
    for kind, nbytes, shape, _ in ops:
        out[kind] += nbytes
        count[kind] += 1
        listed.append((nbytes, kind, shape))
    listed.sort(reverse=True)
    total = sum(out.values())
    wire = total + out.get("all-reduce", 0.0)
    return {"per_kind": dict(out), "counts": dict(count),
            "total_bytes": total, "wire_bytes": wire,
            "top_ops": [{"bytes": b, "kind": k, "shape": s}
                        for b, k, s in listed[:top_n]]}
