"""The port's recurrent-state modules against the JAX package's, on the
CPU, on shared numpy params and inputs at ``ModelConfig.reduced()`` in
fp32: Mamba (``models/mamba.py::mamba_forward``), RWKV6's time mix and
channel mix (``models/rwkv6.py``), each from a zero state and from a
carried one, outputs and new states within 1e-5 (the recurrences run in
another order: the reference's associative scan and chunked ``lax.scan``
against the port's loop over tokens, which agree to ~1e-6 here);
layernorm within 1e-6; the properties the reference's
``tests/test_rwkv_mamba.py`` holds (full forward == token by token with
the carried state, at its tolerances 1e-4 and 1e-3 for ``S``; a forward
split anywhere with the state carried == the whole, the counterpart of
its chunk-size invariance; the decay in (0, 1); the channel mix's one-token
shift); the param leaves' dtypes (fp32 where the reference pins them,
whatever the model's dtype); and which configs the stack accepts."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.models import init_model  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import mamba as JM  # noqa: E402
from repro.models import rwkv6 as JR  # noqa: E402
from repro_torch.bridge import init_params, params_from_jax  # noqa: E402
from repro_torch.configs import ARCHITECTURES, get_config  # noqa: E402
from repro_torch.configs.base import check_supported  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import mamba as M  # noqa: E402
from repro_torch.models import rwkv6 as R  # noqa: E402

torch.set_num_threads(2)

TOL = 1e-5
JAMBA, RWKV6 = "jamba-v0.1-52b", "rwkv6-1.6b"


def _cfgs(name, **kw):
    jcfg = jax_get_config(name).reduced(dtype="float32", **kw)
    return jcfg, get_config(name).reduced(dtype="float32", **kw)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.as_tensor(np.array(tree))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


def _x(shape, seed, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


@pytest.fixture(scope="module")
def mamba():
    jcfg, cfg = _cfgs(JAMBA)
    params = _np(JM.init_mamba(jax.random.PRNGKey(0), jcfg))
    return jcfg, cfg, params


@pytest.fixture(scope="module")
def rwkv():
    jcfg, cfg = _cfgs(RWKV6)
    tm = _np(JR.init_time_mix(jax.random.PRNGKey(0), jcfg))
    cm = _np(JR.init_channel_mix(jax.random.PRNGKey(1), jcfg))
    return jcfg, cfg, tm, cm


def _mamba_state(cfg, b, seed):
    e = cfg.mamba_expand * cfg.d_model
    return {"conv": _x((b, cfg.mamba_d_conv - 1, e), seed),
            "ssm": _x((b, e, cfg.mamba_d_state), seed + 1, 0.1)}


def _rwkv_state(cfg, b, seed):
    H, hs = R.n_rwkv_heads(cfg), cfg.rwkv_head_size
    return {"S": _x((b, H, hs, hs), seed, 0.2),
            "tm_shift": _x((b, cfg.d_model), seed + 1),
            "cm_shift": _x((b, cfg.d_model), seed + 2)}


@pytest.mark.parametrize("carried", [False, True], ids=["zero", "carried"])
@pytest.mark.parametrize("L", [1, 19])
def test_mamba_forward_matches_jax(mamba, carried, L):
    jcfg, cfg, params = mamba
    x = _x((3, L, cfg.d_model), 2)
    state = _mamba_state(cfg, 3, 3) if carried else None
    want_y, want_s = JM.mamba_forward(
        params, jnp.asarray(x), jcfg, remat=False, chunk=8,
        state=None if state is None else
        {k: jnp.asarray(v) for k, v in state.items()})
    got_y, got_s = M.mamba_forward(_t(params), torch.as_tensor(x), cfg,
                                   state=None if state is None
                                   else _t(state))
    _close(got_y, want_y)
    assert sorted(got_s) == sorted(want_s) == ["conv", "ssm"]
    for k in want_s:
        assert got_s[k].dtype == {"conv": torch.float32,
                                  "ssm": torch.float32}[k]
        _close(got_s[k], want_s[k])


def test_mamba_coefficients_match_jax(mamba):
    jcfg, cfg, params = mamba
    u = _x((2, 7, cfg.mamba_expand * cfg.d_model), 4)
    want = JM._ssm_coeffs(params, jnp.asarray(u), jcfg)
    got = M._ssm_coeffs(_t(params), torch.as_tensor(u), cfg)
    for g, w in zip(got, want):
        _close(g, w)
    assert M.dt_rank(cfg) == JM.dt_rank(jcfg)
    assert M.dt_rank(get_config(JAMBA)) == 256


@pytest.mark.parametrize("carried", [False, True], ids=["zero", "carried"])
@pytest.mark.parametrize("L", [1, 13])
def test_time_mix_and_channel_mix_match_jax(rwkv, carried, L):
    jcfg, cfg, tm, cm = rwkv
    b = 3
    x = _x((b, L, cfg.d_model), 5)
    state = (_rwkv_state(cfg, b, 6) if carried
             else _np(JR.init_rwkv_state(jcfg, b)))
    jstate = {k: jnp.asarray(v) for k, v in state.items()}
    want_y, want_s = JR.time_mix(tm, jnp.asarray(x), jcfg, jstate, chunk=4,
                                 remat=False)
    got_y, got_s = R.time_mix(_t(tm), torch.as_tensor(x), cfg, _t(state))
    _close(got_y, want_y)
    assert sorted(got_s) == sorted(want_s) == ["S", "tm_shift"]
    for k in want_s:
        _close(got_s[k], want_s[k])
    want_y, want_s = JR.channel_mix(cm, jnp.asarray(x), jcfg, jstate)
    got_y, got_s = R.channel_mix(_t(cm), torch.as_tensor(x), cfg, _t(state))
    _close(got_y, want_y)
    _close(got_s["cm_shift"], want_s["cm_shift"])


def test_layernorm_matches_jax():
    """Population variance (``jnp.var``), a bias, fp32 inside and the input
    dtype out."""
    _, cfg = _cfgs(RWKV6)
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((4, 9, cfg.d_model)) * 3 + 1).astype(np.float32)
    p = {"w": rng.standard_normal(cfg.d_model).astype(np.float32),
         "b": rng.standard_normal(cfg.d_model).astype(np.float32)}
    want = JL.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x), cfg)
    got = L.apply_norm(_t(p), torch.as_tensor(x), cfg)
    _close(got, want, 1e-6)
    xb = torch.as_tensor(x).bfloat16()
    assert L.apply_norm(_t(p), xb, cfg).dtype == torch.bfloat16
    # the unbiased variance would differ by a factor d / (d - 1)
    unbiased = torch.as_tensor(x).var(-1, keepdim=True)
    assert not torch.allclose(unbiased, torch.as_tensor(x).var(
        -1, keepdim=True, correction=0))


# ---------------------------------------------------------------------------
# the reference's recurrence properties, on the port
# ---------------------------------------------------------------------------
def test_mamba_full_forward_equals_token_by_token():
    _, cfg = _cfgs(JAMBA, d_model=64)
    jcfg = jax_get_config(JAMBA).reduced(dtype="float32", d_model=64)
    params = _t(_np(JM.init_mamba(jax.random.PRNGKey(0), jcfg)))
    x = torch.as_tensor(_x((2, 24, cfg.d_model), 1))
    full, st_full = M.mamba_forward(params, x, cfg)
    st, outs = None, []
    for t in range(x.shape[1]):
        y, st = M.mamba_forward(params, x[:, t:t + 1], cfg, state=st)
        outs.append(y)
    step = torch.cat(outs, 1)
    assert float((full - step).abs().max()) < 1e-4
    assert float((st_full["ssm"] - st["ssm"]).abs().max()) < 1e-4
    assert float((st_full["conv"] - st["conv"]).abs().max()) < 1e-5


@pytest.mark.parametrize("split", [4, 13])
def test_mamba_split_forward_equals_whole(split):
    """The port has no chunks: a forward split at any token, with the state
    carried, equals the whole one (the reference's chunk-size invariance)."""
    _, cfg = _cfgs(JAMBA, d_model=64)
    jcfg = jax_get_config(JAMBA).reduced(dtype="float32", d_model=64)
    params = _t(_np(JM.init_mamba(jax.random.PRNGKey(0), jcfg)))
    x = torch.as_tensor(_x((1, 32, cfg.d_model), 1))
    whole, _ = M.mamba_forward(params, x, cfg)
    a, st = M.mamba_forward(params, x[:, :split], cfg)
    b, _ = M.mamba_forward(params, x[:, split:], cfg, state=st)
    assert float((whole - torch.cat([a, b], 1)).abs().max()) < 1e-4


def test_rwkv_time_mix_full_forward_equals_token_by_token():
    _, cfg = _cfgs(RWKV6, d_model=128)
    jcfg = jax_get_config(RWKV6).reduced(dtype="float32", d_model=128)
    params = _t(_np(JR.init_time_mix(jax.random.PRNGKey(0), jcfg)))
    b, L = 2, 20
    x = torch.as_tensor(_x((b, L, cfg.d_model), 1))
    st0 = R.init_rwkv_state(cfg, b)
    full, st_full = R.time_mix(params, x, cfg, st0)
    st, outs = dict(st0), []
    for t in range(L):
        y, new = R.time_mix(params, x[:, t:t + 1], cfg, st)
        st = {**st, **new}
        outs.append(y)
    step = torch.cat(outs, 1)
    assert float((full - step).abs().max()) < 1e-4
    assert float((st_full["S"] - st["S"]).abs().max()) < 1e-3


def test_rwkv_decay_in_unit_interval():
    _, cfg = _cfgs(RWKV6, d_model=128)
    jcfg = jax_get_config(RWKV6).reduced(dtype="float32", d_model=128)
    p = _t(_np(JR.init_time_mix(jax.random.PRNGKey(0), jcfg)))
    x = torch.as_tensor(_x((1, 8, cfg.d_model), 1, 1.0))
    prev = torch.cat([torch.zeros(1, 1, cfg.d_model), x[:, :-1]], 1)
    xw = R._lerp(x, prev, p["mu_w"])
    decay = torch.exp(-torch.exp(p["w0"] + torch.tanh(xw @ p["wa"])
                                 @ p["wb"]))
    assert bool((decay > 0).all()) and bool((decay < 1).all())


def test_rwkv_channel_mix_token_shift():
    _, cfg = _cfgs(RWKV6, d_model=64)
    jcfg = jax_get_config(RWKV6).reduced(dtype="float32", d_model=64)
    params = _t(_np(JR.init_channel_mix(jax.random.PRNGKey(0), jcfg)))
    x = torch.as_tensor(_x((1, 6, cfg.d_model), 1, 1.0))
    st = R.init_rwkv_state(cfg, 1)
    full, _ = R.channel_mix(params, x, cfg, st)
    x2 = x.clone()
    x2[:, 2] += 1.0
    pert, _ = R.channel_mix(params, x2, cfg, st)
    d = (full - pert).abs().sum(-1)[0]
    assert float(d[1]) < 1e-6 and float(d[2]) > 1e-6 and float(d[3]) > 1e-6
    assert float(d[4]) < 1e-6


# ---------------------------------------------------------------------------
# params and configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", [JAMBA, RWKV6])
def test_pinned_leaves_keep_the_reference_dtypes_in_bf16(name):
    """At ``dtype="bfloat16"`` the reference keeps ``A_log``, ``D``, ``w0``,
    ``u``, ``ln_w``, ``ln_b`` (and the MoE router) in fp32: the port's
    ``params_from_jax`` and seeded init give every leaf the reference's
    dtype and shape."""
    jcfg = jax_get_config(name).reduced(dtype="bfloat16")
    cfg = get_config(name).reduced(dtype="bfloat16")
    tree = init_model(jax.random.PRNGKey(0), jcfg)
    flat = {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}
    want = {k: torch.float32 if v.dtype == jnp.float32 else torch.bfloat16
            for k, v in flat.items()}
    assert {k for k, v in want.items() if v == torch.float32} >= (
        {"slots/0/mamba/A_log", "slots/0/mamba/D"} if name == JAMBA else
        {"slots/0/rwkv_tm/w0", "slots/0/rwkv_tm/u", "slots/0/rwkv_tm/ln_w",
         "slots/0/rwkv_tm/ln_b"})

    def flat_port(tree, prefix=""):
        if isinstance(tree, (dict, tuple)):
            items = tree.items() if isinstance(tree, dict) else \
                enumerate(tree)
            out = {}
            for k, v in items:
                out.update(flat_port(v, f"{prefix}{k}/"))
            return out
        return {prefix[:-1]: tree}

    for params in (params_from_jax(_np(tree), cfg, "cpu"),
                   init_params(cfg, torch.Generator().manual_seed(0), "cpu")):
        got = flat_port(params)
        assert sorted(got) == sorted(want)
        for k, dt in want.items():
            assert got[k].dtype == dt, k
            shape = tuple(flat[k].shape)
            assert tuple(got[k].shape) == (shape[::-1] if k == "embed/head"
                                           else shape), k


def test_seeded_init_constants_equal_the_reference():
    """The init forms that are not normal draws: Mamba's ``A_log`` =
    log(1..N), ``dt_proj_b`` = softplus^-1(0.01), ``D`` ones; RWKV's
    ``mu_*`` 0.5, ``w0`` -6, the group norm's ones and zeros, layernorm's
    bias zeros."""
    for name in (JAMBA, RWKV6):
        jcfg, cfg = _cfgs(name)
        tree = _np(init_model(jax.random.PRNGKey(0), jcfg))
        params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        slot_j, slot_t = tree["slots"][0], params["slots"][0]
        keys = ({"mamba": ("A_log", "dt_proj_b", "D", "conv_b")}
                if name == JAMBA else
                {"rwkv_tm": ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g", "w0",
                             "ln_w", "ln_b"),
                 "rwkv_cm": ("mu_k", "mu_r"), "norm1": ("w", "b")})
        for mod, leaves in keys.items():
            for leaf in leaves:
                np.testing.assert_allclose(slot_t[mod][leaf].numpy(),
                                           slot_j[mod][leaf], rtol=1e-6,
                                           err_msg=f"{mod}/{leaf}")
        if name == RWKV6:
            np.testing.assert_array_equal(params["final_norm"]["b"].numpy(),
                                          tree["final_norm"]["b"])


def test_supported_configs():
    """Every registry config builds, whisper-base (an encoder, sinusoidal
    positions, a plain gelu) too; refused are no positions on a config
    with attention, an unknown activation and an unknown norm."""
    for name, cfg in ARCHITECTURES.items():
        check_supported(cfg)
    assert ARCHITECTURES["whisper-base"].activation == "gelu_plain"
    qwen = get_config("qwen2-0.5b")
    with pytest.raises(ValueError, match="repro_torch runs"):
        check_supported(dataclasses.replace(qwen, pos_embed="none"))
    with pytest.raises(ValueError, match="repro_torch runs"):
        check_supported(dataclasses.replace(qwen, activation="swish"))
    with pytest.raises(ValueError, match="repro_torch runs"):
        check_supported(dataclasses.replace(qwen, norm_type="batchnorm"))
