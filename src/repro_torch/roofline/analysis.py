"""The three-term roofline of a dry-run step, counted on the meta device:
the counterpart of the JAX package's ``roofline/analysis.py``.

The reference compiles each step for 512 placeholder devices and reads
per-device FLOPs and bytes from XLA's ``cost_analysis`` and collectives
from the partitioned HLO. PyTorch has neither, so a step here runs once on
the meta device under :class:`MetaCounter`, a ``TorchDispatchMode`` that
sees every aten op the step dispatches (the backward's too) and counts:

- FLOPs: ``torch.utils.flop_counter``'s formulas (matmuls, batched
  matmuls, convolutions, attention) over the whole step, every layer;
- bytes: each op's tensor operands plus its outputs (a view moves none;
  an operand no larger than its storage counts whole, an expanded one its
  storage). This is an unfused count: every intermediate goes to memory
  and back, so it overstates what the port's fused kernels and the
  generic attention's online softmax move (a flash kernel keeps its
  scores on chip);
- the peak of live bytes: the storages the step's ops create, alive
  while any tensor holding them is (saved activations included), not the
  inputs.

Per chip, as in the reference:
    compute term    = counted FLOPs / chips / hw.peak_flops
    memory term     = counted bytes / chips / hw.hbm_bw
    collective term = sum over the step's collectives of wire bytes / the
                      rate of the links its group crosses
with the collectives listed from the step's specs
(``roofline/collectives.py``; wire bytes as the reference counts them: an
all-reduce twice its output, any other op once). The reference divides
all of them by one TPU link rate. Here the mesh is laid on DGX H100-class
nodes (``configs.base.DGX_H100``): ranks row-major over the mesh's axes,
the last (``model``) innermost, so 8 consecutive ranks share a node. A
group inside one node runs at NVLink's rate (450 GB/s each way); a group
that spans nodes at the network's (50 GB/s each way per GPU, InfiniBand
NDR). At 16x16 and 2x16x16 every group spans nodes (a model group is 16
consecutive ranks, a data group strides 16), so every collective is
priced at 50 GB/s; at 2x4 all run on NVLink. MODEL_FLOPS = 6 N D
(training) or 2 N D (inference) with N the active params, and the
useful-compute ratio MODEL_FLOPS / counted FLOPs. ``memory_analysis`` per chip: argument bytes
are each input leaf's size over its spec's shards (a replicated leaf
counts whole), output bytes the same for the outputs, temp bytes the peak
of live bytes over the chips a batch row is split across (activations are
batch-sharded; this counts replicated ones, and the gathered parameters
FSDP would hold, not at all). Dividing whole-step counts by the chips
assumes the work splits evenly, which the reference's partitioned counts
do not need to assume.

Identical ops (the same aten op on operands of the same shapes, strides
and dtypes, with the same other arguments) that neither alias nor write
an operand are computed once: later ones take a fresh meta tensor of the
first's result, which keeps a full-depth count of a 32k-token prefill to
seconds a layer.
"""
from __future__ import annotations

import dataclasses
import functools
import time
import weakref
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs.base import (DGX_H100, H100, HardwareConfig,
                                      ModelConfig)
from repro_torch.parallel import sharding as SH
from repro_torch.roofline.collectives import collective_bytes


def model_flops(cfg: ModelConfig, tokens: int, kind: str) -> float:
    """6·N·D for training; 2·N·D for inference steps (fwd only)."""
    n = cfg.active_param_count()
    mult = 6.0 if kind.startswith("train") else 2.0
    return mult * n * tokens


def _key(x):
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.stride(), x.dtype, x.device.type)
    if isinstance(x, (list, tuple)):
        return (type(x).__name__,) + tuple(_key(y) for y in x)
    return x


def _bytes(t: torch.Tensor) -> int:
    return min(t.numel() * t.element_size(), t.untyped_storage().nbytes())


def _tensors(xs, out):
    for x in xs:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            _tensors(x, out)
    return out


class MetaCounter(TorchDispatchMode):
    """Counts FLOPs, bytes and the peak of live bytes of what runs under
    it (see the module's docstring)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.live = 0
        self.peak = 0
        self._storages: Dict[int, list] = {}
        self._memo: Dict[Any, Any] = {}
        self._pure: Dict[Any, tuple] = {}

    def _kind(self, func):
        """(aliases an operand in its result, writes an operand)."""
        got = self._pure.get(func)
        if got is None:
            sch = func._schema
            got = (any(r.alias_info is not None for r in sch.returns),
                   any(a.alias_info is not None and a.alias_info.is_write
                       for a in sch.arguments))
            self._pure[func] = got
        return got

    def _release(self, key):
        rec = self._storages.get(key)
        if rec is None:
            return
        rec[1] -= 1
        if rec[1] == 0:
            self.live -= rec[0]
            del self._storages[key]

    def _track(self, t: torch.Tensor, new: bool):
        st = t.untyped_storage()
        key = st._cdata
        rec = self._storages.get(key)
        if rec is None:
            if not new:
                return          # a view of an input: not the step's memory
            rec = self._storages[key] = [st.nbytes(), 0]
            self.live += rec[0]
            self.peak = max(self.peak, self.live)
        rec[1] += 1
        weakref.finalize(t, self._release, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.ops += 1
        aliases, writes = self._kind(func)
        out = None
        key = None
        if not (aliases or writes):
            try:
                key = (func, _key(args), _key(tuple(sorted(kwargs.items()))))
                hash(key)
            except TypeError:
                key = None
            spec = self._memo.get(key) if key is not None else None
            if spec is not None:
                out = tuple(torch.empty_strided(s, st, dtype=d,
                                                device="meta")
                            for s, st, d in spec)
                if len(out) == 1 and not isinstance(spec, list):
                    out = out[0]
        if out is None:
            out = func(*args, **kwargs)
            if key is not None:
                if isinstance(out, torch.Tensor):
                    self._memo[key] = ((tuple(out.shape), out.stride(),
                                        out.dtype),)
                elif (isinstance(out, (tuple, list)) and out
                      and all(isinstance(o, torch.Tensor) for o in out)):
                    self._memo[key] = [(tuple(o.shape), o.stride(), o.dtype)
                                       for o in out]
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        outs = _tensors([out], [])
        if not aliases:
            seen = set()
            for t in _tensors([args, list(kwargs.values())], []) + (
                    [] if writes else outs):
                if id(t) not in seen:
                    seen.add(id(t))
                    self.bytes += _bytes(t)
        for t in outs:
            self._track(t, new=not (aliases or writes))
        return out


def sharded_bytes(tree, specs, mesh) -> float:
    """Per-chip bytes of ``tree``'s tensors under ``specs`` (a spec tree
    mirroring it; a replicated leaf counts whole). Walks ``tree``: the
    specs' leaves are tuples."""
    if isinstance(tree, torch.Tensor):
        return (tree.numel() * tree.element_size()
                / SH.shard_count(specs, mesh))
    if isinstance(tree, dict):
        return sum(sharded_bytes(v, specs[k], mesh) for k, v in tree.items())
    if isinstance(tree, (tuple, list)):
        return sum(sharded_bytes(v, specs[i], mesh)
                   for i, v in enumerate(tree))
    return 0.0


def count(plan) -> Dict[str, Any]:
    """Run ``plan.fn`` on its meta args under :class:`MetaCounter`:
    {"flops", "bytes", "peak_bytes", "ops", "seconds", "outputs"}."""
    t0 = time.perf_counter()
    counter = MetaCounter()
    with torch.set_grad_enabled(plan.grad), counter:
        out = plan.fn(*plan.args)
    return {"flops": float(counter.flops), "bytes": float(counter.bytes),
            "peak_bytes": float(counter.peak), "ops": counter.ops,
            "seconds": time.perf_counter() - t0, "outputs": out}


def memory_analysis(plan, counts, mesh) -> Dict[str, int]:
    """Per-chip ``temp_bytes``, ``argument_bytes``, ``output_bytes`` (see
    the module's docstring)."""
    args = sum(sharded_bytes(a, s, mesh)
               for a, s in zip(plan.args, plan.in_specs))
    out = counts["outputs"]
    return {"temp_bytes": int(counts["peak_bytes"] / plan.batch_shards),
            "argument_bytes": int(args),
            "output_bytes": int(sharded_bytes(out, plan.out_specs(out),
                                              mesh))}


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float       # counted FLOPs per chip (no HLO: the field keeps
    hlo_bytes: float       # the reference's name, as the report reads it)
    coll_bytes: float
    coll_detail: Dict[str, Any]
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    useful_ratio: float
    bottleneck: str
    per_device_mem: Optional[float]

    def to_dict(self):
        return dataclasses.asdict(self)


@functools.lru_cache(maxsize=None)
def spans_nodes(mesh, axes, node_gpus: int) -> bool:
    """Whether a group over ``axes`` of ``mesh`` (ranks row-major over
    its axes, the last innermost) holds GPUs of more than one node of
    ``node_gpus``."""
    stride, acc = {}, 1
    for name, size in reversed(tuple(zip(mesh.axis_names, mesh.sizes))):
        stride[name] = acc
        acc *= size
    offsets = [0]
    for a in axes:
        offsets = [o + i * stride[a] for o in offsets
                   for i in range(mesh.shape[a])]
    for r in range(acc):
        base = r - sum((r // stride[a]) % mesh.shape[a] * stride[a]
                       for a in axes)
        if len({(base + o) // node_gpus for o in offsets}) > 1:
            return True
    return False


def collective_seconds(ops, mesh):
    """(seconds, per-axes detail) of a step's collectives on
    ``DGX_H100`` (see the module's docstring)."""
    detail: Dict[str, Dict[str, Any]] = {}
    total = 0.0
    for kind, nbytes, _, axes in ops:
        wire = nbytes * (2 if kind == "all-reduce" else 1)
        rate = (DGX_H100.network_bw
                if spans_nodes(mesh, axes, DGX_H100.node_gpus)
                else DGX_H100.nvlink_bw)
        d = detail.setdefault(",".join(axes), {"wire_bytes": 0.0,
                                                "rate": rate, "seconds": 0.0})
        d["wire_bytes"] += wire
        d["seconds"] += wire / rate
        total += wire / rate
    return total, detail


def analyze(plan, counts, *, cfg: ModelConfig, shape_name: str,
            mesh_name: str, chips: int, tokens: int, kind: str,
            hw: HardwareConfig = H100, memory=None) -> RooflineReport:
    """The report of a counted plan (``counts``: :func:`count`'s)."""
    flops = counts["flops"] / chips
    nbytes = counts["bytes"] / chips
    coll = collective_bytes(plan.collectives)
    compute_s = flops / hw.peak_flops
    memory_s = nbytes / hw.hbm_bw
    collective_s = collective_seconds(plan.collectives, plan.mesh)[0]
    mf = model_flops(cfg, tokens, kind)
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    mem = (None if memory is None else
           float(memory["temp_bytes"] + memory["argument_bytes"]
                 + memory["output_bytes"]))
    return RooflineReport(
        arch=cfg.name, shape=shape_name, mesh=mesh_name, chips=chips,
        hlo_flops=flops, hlo_bytes=nbytes, coll_bytes=coll["total_bytes"],
        coll_detail=coll, compute_s=compute_s, memory_s=memory_s,
        collective_s=collective_s, model_flops=mf,
        useful_ratio=mf / (flops * chips) if flops else 0.0,
        bottleneck=max(terms, key=terms.get), per_device_mem=mem)
