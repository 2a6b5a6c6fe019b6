"""The port's configs and params bridge: the JAX param tree (and its npz
checkpoint keys) round-trips through ``params_from_jax``; the seeded init
draws the JAX init's shapes and distributions; configs (and the dry-run's
input shapes) match the JAX package's field for field."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.checkpoint import save  # noqa: E402
from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.models import init_model  # noqa: E402
from repro_torch.bridge import (  # noqa: E402
    init_params,
    param_count,
    params_from_jax,
)
from repro_torch.configs import ARCHITECTURES, get_config  # noqa: E402
from repro_torch.configs import base as port_base  # noqa: E402
from repro.configs import base as jax_base  # noqa: E402

torch.set_num_threads(2)


def _flat(tree, prefix=""):
    """Leaves keyed like ``checkpoint/io.py`` ("slots/0/attn/wq")."""
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


def _jax_tree(name):
    jcfg = jax_get_config(name).reduced()
    tree = jax.tree_util.tree_map(np.asarray,
                                  init_model(jax.random.PRNGKey(0), jcfg))
    return jcfg, get_config(name).reduced(), tree


def _check_round_trip(params, tree):
    got, want = _flat(params), _flat(tree)
    assert sorted(got) == sorted(want)
    for key, leaf in want.items():
        g = got[key].numpy()
        if key == "embed/head":            # the port stores (V, d)
            g = g.T
        assert g.shape == leaf.shape, key
        np.testing.assert_array_equal(g, leaf, key)


@pytest.mark.parametrize("name", ["qwen2-0.5b", "dream-7b", "gemma-7b",
                                  "gemma2-27b", "llama4-maverick-400b-a17b",
                                  "kimi-k2-1t-a32b", "jamba-v0.1-52b",
                                  "rwkv6-1.6b", "whisper-base",
                                  "internvl2-1b"])
def test_round_trip_of_the_jax_tree(name):
    """Every leaf, ``ATTN_LOCAL`` slots and ``moe`` leaves (the fp32
    router, the (E, d, f) / (E, f, d) experts, the shared expert), Mamba
    and RWKV leaves, layernorm's biases, and whisper's encoder, cross
    attention and plain MLP too."""
    _, cfg, tree = _jax_tree(name)
    params = params_from_jax(tree, cfg, "cpu")
    _check_round_trip(params, tree)
    assert param_count(params) == sum(a.size for a in _flat(tree).values())
    for key, leaf in _flat(tree).items():
        assert _flat(params)[key].dtype == (
            torch.float32 if leaf.dtype == np.float32 else torch.bfloat16)


def test_npz_checkpoint_keys(tmp_path):
    jcfg, cfg, tree = _jax_tree("qwen2-0.5b")
    path = tmp_path / "ckpt.npz"
    save(init_model(jax.random.PRNGKey(0), jcfg), str(path))
    with np.load(path) as data:
        assert "slots/0/attn/wq" in data and "embed/tok" in data
        params = params_from_jax(data, cfg, "cpu")
    _check_round_trip(params, tree)


def test_shape_mismatch_is_refused():
    _, cfg, tree = _jax_tree("qwen2-0.5b")
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(tree, dataclasses.replace(cfg, d_ff=64), "cpu")


@pytest.mark.parametrize("name", ["qwen2-0.5b", "llada-8b",
                                  "gemma2-27b", "kimi-k2-1t-a32b",
                                  "jamba-v0.1-52b", "rwkv6-1.6b",
                                  "whisper-base"])
def test_seeded_init_follows_the_jax_init(name):
    _, cfg, tree = _jax_tree(name)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    flat = _flat(params)
    for key, leaf in _flat(tree).items():
        shape = leaf.shape[::-1] if key == "embed/head" else leaf.shape
        assert tuple(flat[key].shape) == shape, key
        assert flat[key].dtype == torch.float32
        if leaf.std() == 0:                # ones / zeros
            np.testing.assert_array_equal(flat[key].numpy(), leaf)
        else:                              # same normal, other draws
            assert abs(flat[key].std().item() / leaf.std() - 1) < 0.05, key
    again = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    other = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    tok = params["embed"]["tok"]
    assert torch.equal(tok, again["embed"]["tok"])
    assert not torch.equal(tok, other["embed"]["tok"])


@pytest.mark.parametrize("name", sorted(ARCHITECTURES))
def test_configs_match_the_jax_package(name):
    """Every config copied from the JAX package equals it field for field,
    and leaves the port's own fields (``PORT_FIELDS``) at their defaults,
    whole and reduced."""
    mine, theirs = get_config(name), jax_get_config(name)
    jax_fields = [f.name for f in dataclasses.fields(theirs)]
    assert [f.name for f in dataclasses.fields(mine)
            if f.name not in port_base.PORT_FIELDS] == jax_fields
    defaults = {f.name: f.default for f in dataclasses.fields(mine)
                if f.name in port_base.PORT_FIELDS}
    assert set(defaults) == set(port_base.PORT_FIELDS)
    for f in jax_fields:
        assert getattr(mine, f) == getattr(theirs, f), f
    assert mine.param_count() == theirs.param_count()
    assert dataclasses.asdict(mine.reduced()) == {
        **{f: getattr(theirs.reduced(), f) for f in jax_fields}, **defaults}
    for cfg in (mine, mine.reduced()):
        assert {f: getattr(cfg, f) for f in defaults} == defaults


@pytest.mark.parametrize("name", ["CDLMConfig", "TrainConfig",
                                  "ServeConfig"])
def test_training_and_serving_configs_match_the_jax_package(name):
    mine, theirs = getattr(port_base, name)(), getattr(jax_base, name)()
    assert [f.name for f in dataclasses.fields(mine)] == \
        [f.name for f in dataclasses.fields(theirs)]
    for f in dataclasses.fields(mine):
        assert getattr(mine, f.name) == getattr(theirs, f.name), f.name
    if name == "CDLMConfig":
        assert mine.n_blocks == theirs.n_blocks


def test_input_shapes_match_the_jax_package():
    """The dry-run's four input shapes, field for field."""
    mine, theirs = port_base.INPUT_SHAPES, jax_base.INPUT_SHAPES
    assert list(mine) == list(theirs)
    assert [f.name for f in dataclasses.fields(port_base.ShapeConfig)] == \
        [f.name for f in dataclasses.fields(jax_base.ShapeConfig)]
    for name, shape in mine.items():
        for f in dataclasses.fields(shape):
            assert getattr(shape, f.name) == getattr(theirs[name], f.name)


def test_unported_architectures_are_refused():
    """The registry holds every architecture and the port's stack builds
    each (whisper-base since its encoder, sinusoidal positions and plain
    gelu were ported: its encoder and every decoder slot's cross attention
    are in the params); a config it does not run (no positions on an
    attention config) is refused when params are built, and an unknown
    name is refused by the registry."""
    cfg = get_config("whisper-base").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert set(params["slots"][0]) >= {"cross", "norm_cross"}
    assert params["encoder"]["slots"][0]["mlp"]["wi"].shape == (
        cfg.n_encoder_layers, cfg.d_model, cfg.d_ff)
    for name in ("jamba-v0.1-52b", "rwkv6-1.6b"):
        init_params(get_config(name).reduced(),
                    torch.Generator().manual_seed(0), "cpu")
    bad = dataclasses.replace(get_config("qwen2-0.5b").reduced(),
                              pos_embed="none")
    with pytest.raises(ValueError, match="repro_torch runs"):
        init_params(bad, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(KeyError, match="unknown architecture"):
        get_config("gemma3-1b")


def test_large_leaves_are_drawn_in_chunks(monkeypatch):
    """A leaf over ``DRAW_CHUNK`` elements is built in its own dtype from
    fp32 draws of at most ``DRAW_CHUNK`` elements, with the init's
    distribution."""
    import repro_torch.bridge as bridge
    monkeypatch.setattr(bridge, "DRAW_CHUNK", 1000)
    real = torch.randn
    sizes = []

    def randn(*args, **kw):
        out = real(*args, **kw)
        sizes.append(out.numel())
        return out

    monkeypatch.setattr(torch, "randn", randn)
    cfg = get_config("kimi-k2-1t-a32b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                         dtype="bfloat16")
    assert max(sizes) <= 1000
    moe = params["slots"][0]["moe"]
    assert moe["router"].dtype == torch.float32
    assert moe["wi_gate"].dtype == torch.bfloat16
    std = moe["wi_gate"].float().std().item()
    assert abs(std * cfg.d_model ** 0.5 - 1) < 0.05
