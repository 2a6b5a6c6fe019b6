"""The port's sharding rules (``repro_torch/parallel/sharding.py``) and
meshes against the JAX package's: every leaf's spec of every config at
16x16, 2x16x16 and 2x4, FSDP on and off; ``batch_axes``, ``cache_spec``
and the cache's specs over a grid of sizes (the JAX side on
``jax.sharding.AbstractMesh``, which needs no devices); and the DTensor
placements against the reference's index map (XLA's tile assignment of an
abstract mesh): DTensor's own split at every mesh, and the local shards
on a gloo (2, 2) mesh of four CPU processes."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.launch import specs as jax_specs  # noqa: E402
from repro.parallel import sharding as jax_sharding  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.configs import ARCHITECTURES, get_config  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch.specs import abstract_cache, abstract_params  # noqa: E402,E501
from repro_torch.parallel import sharding as SH  # noqa: E402
from torch.distributed.tensor import Replicate  # noqa: E402

from _torch_dist import run_ranks  # noqa: E402

MESHES = {"16x16": M.make_production_mesh(),
          "2x16x16": M.make_production_mesh(multi_pod=True),
          "2x4": M.make_tiny_mesh(data=2, model=4)}


def _jax_mesh(mesh):
    return AbstractMesh(mesh.sizes, mesh.axis_names)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}{k}/"))
    return out


def test_meshes():
    m1, m2 = M.make_production_mesh(), M.make_production_mesh(multi_pod=True)
    assert m1.shape == {"data": 16, "model": 16} and m1.name == "16x16"
    assert m2.axis_names == ("pod", "data", "model") and m2.name == "2x16x16"
    assert (M.n_chips(m1), M.n_chips(m2)) == (256, 512)
    assert M.make_tiny_mesh().shape == {"data": 2, "model": 4}


@pytest.mark.parametrize("name", sorted(ARCHITECTURES))
def test_every_leaf_spec_equals_jax(name):
    """``param_specs`` of the port's meta tree equals the reference's
    ``param_specs`` of its abstract tree leaf for leaf (the port's (V, d)
    head against the reference's (d, V) one, reversed), and
    ``spec_for_leaf`` equals the reference's on the reference's own paths
    and shapes."""
    jparams = jax_specs.abstract_params(jax_get_config(name))
    jflat = {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                      for p in path): leaf
             for path, leaf in jax.tree_util.tree_leaves_with_path(jparams)}
    params = abstract_params(get_config(name))
    pflat = {T.key_path(path): leaf
             for path, leaf in T.leaves_with_path(params)}
    assert sorted(pflat) == sorted(jflat)
    n = 0
    for mesh in MESHES.values():
        jm = _jax_mesh(mesh)
        for fsdp in (True, False):
            jspecs = jax_sharding.param_specs(jparams, jm, fsdp=fsdp)
            jspec_flat = {
                "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                         for p in path): tuple(s)
                for path, s in jax.tree_util.tree_leaves_with_path(
                    jspecs, is_leaf=lambda x: isinstance(
                        x, jax.sharding.PartitionSpec))}
            for path, leaf in T.leaves_with_path(params):
                key = T.key_path(path)
                want = jspec_flat[key]
                got = SH.leaf_spec(path, leaf, mesh, fsdp=fsdp)
                if key == SH.TRANSPOSED:
                    got = tuple(reversed(got))
                    want = want or (None, None)
                assert got == want, (key, mesh.name, fsdp)
                assert SH.spec_for_leaf(
                    key, jflat[key].shape, mesh, fsdp=fsdp) == tuple(
                    jax_sharding.spec_for_leaf(key, jflat[key].shape, jm,
                                               fsdp=fsdp)), key
                n += 1
    assert n == 6 * len(pflat)
    assert any(SH.spec_axes(s) for s in jspec_flat.values())


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_batch_axes_and_cache_specs_equal_jax(mesh_name):
    mesh = MESHES[mesh_name]
    jm = _jax_mesh(mesh)
    for size in (1, 2, 3, 4, 8, 16, 24, 32, 48, 128, 256, 512, 1024):
        assert SH.batch_axes(mesh, size) == jax_sharding.batch_axes(jm, size)
        for n_kv in (1, 2, 4, 8, 16, 32):
            for seq in (False, True):
                assert SH.cache_spec(mesh, size, n_kv=n_kv,
                                     seq_shard=seq) == tuple(
                    jax_sharding.cache_spec(jm, size, n_kv=n_kv,
                                            seq_shard=seq))


@pytest.mark.parametrize("name", ["qwen2-0.5b", "jamba-v0.1-52b",
                                  "rwkv6-1.6b", "whisper-base",
                                  "gemma-7b"])
def test_cache_specs_equal_jax(name):
    cfg, jcfg = get_config(name).reduced(), jax_get_config(name).reduced()
    for mesh in MESHES.values():
        jm = _jax_mesh(mesh)
        for batch in (1, 4, 32):
            cache = abstract_cache(cfg, batch, 64)
            jcache = jax_specs.abstract_cache(jcfg, batch, 64)
            for seq in (False, True):
                want = {k: tuple(v.spec) for k, v in _flat(
                    jax_specs.cache_shardings(jcache, jm, jcfg, batch,
                                              seq_shard=seq)).items()}
                specs = SH.cache_specs(cache, mesh, cfg, batch,
                                       seq_shard=seq)
                # walk the cache: the specs' leaves are tuples
                mine = {T.key_path(path): specs[path[0]][path[1]]
                        for path, _ in T.leaves_with_path(cache)}
                assert mine == want, (name, mesh.name, batch, seq)


def _jax_blocks(spec, shape, mesh):
    """Per device (its row-major position in ``mesh``), per dim: the
    [start, stop) of the block the reference's ``NamedSharding`` gives it,
    read from the XLA tile assignment of an abstract mesh."""
    jm = _jax_mesh(mesh)
    hlo = NamedSharding(jm, P(*spec))._to_xla_hlo_sharding(len(shape))
    n_dev = M.n_chips(mesh)
    whole = [[0, n] for n in shape]
    if hlo.is_replicated():
        return {dev: whole for dev in range(n_dev)}
    dims = hlo.tile_assignment_dimensions()
    devs = np.array(hlo.tile_assignment_devices()).reshape(dims)
    out = {}
    for pos in np.ndindex(*dims):
        out[int(devs[pos])] = [[t * n // k, (t + 1) * n // k] for n, t, k
                               in zip(shape, pos, dims)]
    assert sorted(out) == list(range(n_dev))
    return out


def _dtensor_indices(places, shape, mesh):
    """Per device, per dim: the global indices DTensor gives it under
    ``places``, by DTensor's own split of each placement, mesh dims left
    to right."""
    out = {}
    for dev, coord in enumerate(np.ndindex(*mesh.sizes)):
        idx = [torch.arange(n).reshape([-1 if e == d else 1
                                        for e in range(len(shape))])
               for d, n in enumerate(shape)]
        for p, c, size in zip(places, coord, mesh.sizes):
            if not isinstance(p, Replicate):
                idx[p.dim] = p._split_tensor(idx[p.dim], size,
                                             with_padding=False)[0][c]
        out[dev] = [t.flatten().tolist() for t in idx]
    return out


@pytest.mark.parametrize("mesh_name", sorted(MESHES) + ["2x2x2"])
def test_placements_follow_the_reference_index_map(mesh_name):
    """Every distinct (spec, shape) of the reduced configs: the indices
    each device holds under ``placements`` are the block the reference's
    ``PartitionSpec`` assigns it, multi-axis entries model-major (the
    FSDP-gathered model shard holds whole heads)."""
    mesh = MESHES.get(mesh_name) or M.Mesh(("pod", "data", "model"),
                                           (2, 2, 2))
    seen = set()
    n_multi = 0
    for name in sorted(ARCHITECTURES):
        params = abstract_params(get_config(name).reduced())
        for path, leaf in T.leaves_with_path(params):
            spec = SH.leaf_spec(path, leaf, mesh)
            key = (spec, tuple(leaf.shape))
            if key in seen:
                continue
            seen.add(key)
            n_multi += any(isinstance(ax, tuple) for ax in spec)
            got = _dtensor_indices(SH.placements(spec, mesh), leaf.shape,
                                   mesh)
            for dev, blocks in _jax_blocks(spec, leaf.shape, mesh).items():
                assert got[dev] == [list(range(a, b)) for a, b in blocks], (
                    name, T.key_path(path), spec, dev)
    assert n_multi > 0


DTENSOR = """
import json
from torch.distributed.tensor import distribute_tensor
from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.launch import mesh as M
from repro_torch.launch.specs import abstract_params
from repro_torch.parallel import sharding as SH
mesh = M.make_tiny_mesh(data=2, model=2)
dm = M.as_device_mesh(mesh, "cpu")
want = json.load(open("blocks.json"))
out = {}
for name in NAMES:
    params = abstract_params(get_config(name).reduced())
    places = SH.param_placements(params, dm)
    for path, leaf in T.leaves_with_path(params):
        node = places
        for k in path:
            node = node[k]
        glob = torch.arange(leaf.numel(), dtype=torch.float64).reshape(
            leaf.shape)
        local = distribute_tensor(glob, dm, list(node)).to_local()
        key = name + ":" + T.key_path(path)
        block = glob[tuple(slice(a, b) for a, b in want[key][str(RANK)])]
        out[key] = [list(local.shape), torch.equal(local, block)]
print(json.dumps(out))
"""
NAMES = ("qwen2-0.5b", "llama4-maverick-400b-a17b", "rwkv6-1.6b")


def test_param_placements_shard_on_a_gloo_mesh(tmp_path):
    """Four CPU ranks, a (data 2, model 2) ``DeviceMesh``: every leaf's
    local shard under ``param_placements`` holds the block of the global
    leaf that the reference's ``param_specs`` assigns the rank's (data,
    model) coordinate (rank = data * 2 + model, both meshes row-major)."""
    mesh = M.make_tiny_mesh(data=2, model=2)
    jm = _jax_mesh(mesh)
    blocks = {}
    for name in NAMES:
        jparams = jax_specs.abstract_params(jax_get_config(name).reduced())
        jspecs = jax_sharding.param_specs(jparams, jm)
        for (path, leaf), spec in zip(
                jax.tree_util.tree_leaves_with_path(jparams),
                jax.tree_util.tree_leaves(jspecs, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))):
            key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                           for p in path)
            got = _jax_blocks(tuple(spec), leaf.shape, mesh)
            if key == SH.TRANSPOSED:        # the port's head is (V, d)
                got = {d: b[::-1] for d, b in got.items()}
            blocks[f"{name}:{key}"] = got
    (tmp_path / "blocks.json").write_text(json.dumps(blocks))
    outs = run_ranks(f"NAMES = {NAMES!r}\n" + DTENSOR, 4, tmp_path)
    for rank, out in enumerate(outs):
        got = json.loads(out.strip().splitlines()[-1])
        assert sorted(got) == sorted(blocks)
        for key, (shape, equal) in got.items():
            assert equal, (rank, key, shape)
    assert sum(any(b[d] != b[0] for d in b) for b in blocks.values()) > 10
