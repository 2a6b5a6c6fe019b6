"""Sharding rules: param-path regex -> logical dims -> a spec per leaf, the
counterpart of the JAX package's ``parallel/sharding.py``.

Policy (the reference's):
- tensor parallelism over the ``model`` mesh axis: attention heads (the
  fused head*hd projection dim), FFN hidden, vocab, MoE experts, Mamba and
  RWKV inner channels;
- FSDP over the ``data`` axis on the complementary matrix dim (ZeRO-3
  style: the optimizer moments take the same spec);
- the ``pod`` axis is a pure data axis (batch, FSDP outer).

Every rule degrades per leaf: an axis is applied to a dim only when the
dim's size is divisible by the axis' extent (qwen2's 14 query heads or
whisper's odd 51,865 vocab fall back to replication on that dim).

A spec is a tuple with one entry per dim of the leaf, each ``None``, an
axis name or a tuple of names (a ``PartitionSpec``'s content); ``()``
replicates. A mesh is ``launch.mesh.Mesh`` or anything with ``.shape``
(name -> extent) and ``.axis_names``. Paths are spelled as the
reference's ``_path_str`` spells them, "/"-joined keys with tuple indices
as numbers ("slots/0/attn/wq"), which is ``tree.key_path``. The port
stores an untied head ``(V, d)``, the transpose of the reference's
``(d, V)``: :func:`param_specs` gives it the reference's spec reversed.
"""
from __future__ import annotations

import math
import re
from typing import Optional, Sequence, Tuple

from repro_torch import tree as T

# (path regex, per-dim logical axes, applied right-aligned to the trailing
# dims; leading stack dims (periods) are never sharded). Logical axes:
# "tp" = the model axis, "fsdp" = the data (and pod) axes, "tp_fsdp" =
# both fused (Megatron column/row parallel at 256-way). Copied from the
# reference, whose comments give each rule's reason.
RULES: Sequence[Tuple[str, Tuple[Optional[str], ...]]] = (
    # embeddings / head: vocab over "model", d (the lm-head contraction
    # dim) replicated
    (r"embed/tok$", ("tp", None)),
    (r"embed/head$", (None, "tp")),
    # attention / dense mlp: the non-contraction dim over (model, data)
    (r"(attn|cross)/w[qkv]$", (None, "tp_fsdp")),
    (r"(attn|cross)/wo$", ("tp_fsdp", None)),
    (r"(attn|cross)/b[qkv]$", ("tp",)),
    (r"mlp/wi(_gate|_up)?$", (None, "tp_fsdp")),
    (r"mlp/wo$", ("tp_fsdp", None)),
    # MoE: expert-parallel on the expert dim
    (r"moe/router$", ("fsdp", None)),
    (r"moe/wi(_gate|_up)$", ("tp", "fsdp", None)),
    (r"moe/wo$", ("tp", None, "fsdp")),
    (r"moe/shared/wi(_gate|_up)$", ("fsdp", "tp")),
    (r"moe/shared/wo$", ("tp", "fsdp")),
    # mamba
    (r"mamba/in_proj$", ("fsdp", "tp")),
    (r"mamba/conv_[wb]$", (None, "tp")),
    (r"mamba/x_proj$", ("tp", None)),
    (r"mamba/dt_proj_w$", (None, "tp")),
    (r"mamba/dt_proj_b$", ("tp",)),
    (r"mamba/A_log$", ("tp", None)),
    (r"mamba/D$", ("tp",)),
    (r"mamba/out_proj$", ("tp", "fsdp")),
    # rwkv6
    (r"rwkv_tm/w[rkvg]$", ("fsdp", "tp")),
    (r"rwkv_tm/wo$", ("tp", "fsdp")),
    (r"rwkv_tm/wa$", ("fsdp", None)),
    (r"rwkv_tm/wb$", (None, "tp")),
    (r"rwkv_cm/wk$", ("fsdp", "tp")),
    (r"rwkv_cm/wv$", ("tp", "fsdp")),
    (r"rwkv_cm/wr$", ("fsdp", "tp")),
    # everything else (norms, mus, scalars): replicated
)

#: the port's leaf stored transposed against the reference's layout
TRANSPOSED = "embed/head"


def axis_size(mesh, name) -> int:
    """Extent of a spec entry: 1 for ``None``, the product for a tuple."""
    if name is None:
        return 1
    if isinstance(name, tuple):
        return math.prod(mesh.shape[n] for n in name)
    return mesh.shape[name]


def logical_to_mesh(mesh, logical: Optional[str], *, fsdp: bool):
    """Logical axis -> concrete mesh axis or axes (or None)."""
    if logical == "tp":
        return "model"
    if logical == "tp_fsdp":
        if not fsdp:
            return "model"
        return (("model", "pod", "data") if "pod" in mesh.axis_names
                else ("model", "data"))
    if logical == "fsdp":
        if not fsdp:
            return None
        return ("pod", "data") if "pod" in mesh.axis_names else "data"
    return None


def spec_for_leaf(path: str, shape: Tuple[int, ...], mesh, *,
                  fsdp: bool) -> tuple:
    """The first rule whose regex matches ``path``, right-aligned to
    ``shape``; ``()`` (replicated) where none does."""
    for pattern, dims in RULES:
        if re.search(pattern, path):
            lead = len(shape) - len(dims)
            if lead < 0:
                break
            axes = [None] * lead
            for d, logical in enumerate(dims):
                concrete = logical_to_mesh(mesh, logical, fsdp=fsdp)
                size = axis_size(mesh, concrete)
                if (concrete is not None and shape[lead + d] % size == 0
                        and size > 1):
                    axes.append(concrete)
                else:
                    axes.append(None)
            return tuple(axes)
    return ()


def leaf_spec(path, leaf, mesh, *, fsdp: bool = True) -> tuple:
    """The spec of the port's param leaf at ``path`` (a ``tree`` key
    path)."""
    name = T.key_path(path)
    shape = tuple(leaf.shape)
    if name == TRANSPOSED:
        spec = spec_for_leaf(name, shape[::-1], mesh, fsdp=fsdp)
        return tuple(reversed(spec or (None, None)))
    return spec_for_leaf(name, shape, mesh, fsdp=fsdp)


def param_specs(params, mesh, *, fsdp: bool = True):
    """A spec tree mirroring ``params`` (the port's tree). Its leaves are
    tuples: walk it beside ``params`` (``tree.leaves_with_path``), not on
    its own."""
    return T.map_with_path(
        lambda path, leaf: leaf_spec(path, leaf, mesh, fsdp=fsdp), params)


def batch_axes(mesh, size: int):
    """Largest prefix of (pod, data) whose product divides ``size``."""
    axes = []
    prod = 1
    for name in ("pod", "data"):
        if name in mesh.axis_names and size % (prod * mesh.shape[name]) == 0:
            axes.append(name)
            prod *= mesh.shape[name]
    if not axes:
        return None
    return tuple(axes) if len(axes) > 1 else axes[0]


def cache_spec(mesh, batch: int, *, n_kv: int, seq_shard: bool) -> tuple:
    """Spec of a K/V cache leaf (np, b, S, kv, hd)."""
    b_ax = batch_axes(mesh, batch)
    if seq_shard:
        return (None, b_ax, "model", None, None)
    kv_ax = "model" if n_kv % mesh.shape["model"] == 0 else None
    return (None, b_ax, None, kv_ax, None)


def cache_specs(cache, mesh, cfg, batch: int, *, seq_shard: bool):
    """A spec per leaf of a dense cache (``core.cache.init_cache``'s tuple
    of slot dicts), by leaf name, as the reference's
    ``launch/specs.py::cache_shardings``: K/V (and the cross attention's
    ``ck``/``cv``) over the batch axes and the KV heads, or the sequence
    when ``seq_shard`` (self attention only); the recurrent states over
    the batch axes and their channel or head dim."""
    b_ax = batch_axes(mesh, batch)
    kv_ok = cfg.n_kv_heads % mesh.shape["model"] == 0

    def spec(path, leaf):
        name = path[-1]
        if name in ("k", "v", "ck", "cv"):
            if seq_shard and name in ("k", "v"):
                return (None, b_ax, "model", None, None)
            return (None, b_ax, None, "model" if kv_ok else None, None)
        if name == "ssm":          # (np, b, e, N)
            return (None, b_ax, "model", None)
        if name == "conv":         # (np, b, dc-1, e)
            return (None, b_ax, None, "model")
        if name == "S":            # (np, b, H, hs, hs)
            return (None, b_ax, "model", None, None)
        if name in ("tm_shift", "cm_shift"):
            return (None, b_ax, "model")
        return ()

    return T.map_with_path(spec, cache)


def shard_count(spec: tuple, mesh) -> int:
    """Into how many pieces a leaf of ``spec`` is cut."""
    return math.prod(axis_size(mesh, ax) for ax in spec)


def spec_axes(spec: tuple) -> set:
    """The mesh axes a spec names."""
    out = set()
    for ax in spec:
        if isinstance(ax, tuple):
            out.update(ax)
        elif ax is not None:
            out.add(ax)
    return out


def placements(spec: tuple, mesh):
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim in the
    mesh's order: ``Replicate()`` where no entry names the dim's axis, else
    a shard of the tensor dim whose entry does. An entry naming several
    axes cuts its dim with the FIRST name the major one (``("model",
    "data")``: piece ``model_index * n_data + data_index``), as a
    ``PartitionSpec`` does, while DTensor applies a mesh's dims left to
    right. So an axis with names before it in the entry that come after it
    in the mesh is a ``_StridedShard`` whose ``split_factor`` is the
    product of those axes' extents (FSDP2 + TP's right-to-left
    sharding)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.placement_types import _StridedShard
    order = {name: i for i, name in enumerate(mesh.axis_names)}
    out = []
    for name in mesh.axis_names:
        dims = [(d, ax) for d, ax in enumerate(spec)
                if ax == name or (isinstance(ax, tuple) and name in ax)]
        if not dims:
            out.append(Replicate())
            continue
        d, ax = dims[0]
        names = ax if isinstance(ax, tuple) else (ax,)
        split = math.prod(mesh.shape[a] for a in names[:names.index(name)]
                          if order[a] > order[name])
        out.append(_StridedShard(d, split_factor=split) if split > 1
                   else Shard(d))
    return tuple(out)


def param_placements(params, device_mesh, *, fsdp: bool = True):
    """``param_shardings``' counterpart: a tree of DTensor placements (one
    per dim of ``device_mesh``, whose dim names are the mesh's axis names)
    mirroring ``params``."""
    from repro_torch.launch.mesh import Mesh
    names = tuple(device_mesh.mesh_dim_names)
    mesh = Mesh(names, tuple(device_mesh.mesh.shape))
    return T.map_with_path(
        lambda path, leaf: placements(leaf_spec(path, leaf, mesh, fsdp=fsdp),
                                      mesh), params)
