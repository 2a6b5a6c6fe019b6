"""The port's MoE FFN (``repro_torch/models/moe.py``) against the JAX
package's ``models/moe.py`` on the same params and inputs (built with the
JAX init and numpy, handed over as numpy), in fp32 at kimi-k2's reduced
config (4 experts, top 2, a shared expert): the five cases of
``tests/test_moe.py`` (dispatch == dense when dropless, capacity drops,
the balanced aux minimum, gate normalisation, the shared expert), each
also against the JAX output, and a planted routing tie. Outputs within
1e-5 (fp32, the same arithmetic in another order); the aux loss within
1e-6."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.models import moe as JMO  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe as MO  # noqa: E402

torch.set_num_threads(2)

TOL = 1e-5


def _cfgs(name="kimi-k2-1t-a32b", **kw):
    return (jax_get_config(name).reduced(dtype="float32", **kw),
            get_config(name).reduced(dtype="float32", **kw))


def _params(jcfg, seed=0):
    return jax.tree_util.tree_map(np.asarray,
                                  JMO.init_moe(jax.random.PRNGKey(seed), jcfg))


def _torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.tensor(np.asarray(a)),
                                  tree)


def _x(shape, seed=1, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _both(params, x, jcfg, cfg, dropless):
    want, want_aux = JMO.apply_moe(jax.tree_util.tree_map(jnp.asarray,
                                                          params),
                                   jnp.asarray(x), jcfg, dropless=dropless)
    got, aux = MO.apply_moe(_torch(params), torch.tensor(x), cfg,
                            dropless=dropless, moe_per_row=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(aux.item(), float(want_aux), rtol=1e-6)
    return got, aux


def test_dispatch_matches_dense_when_dropless():
    jcfg, cfg = _cfgs()
    params = _params(jcfg)
    x = _x((2, 8, cfg.d_model), scale=0.5)
    out, aux = _both(params, x, jcfg, cfg, dropless=True)
    ref = MO.apply_moe_dense_fallback(_torch(params), torch.tensor(x), cfg)
    jref = JMO.apply_moe_dense_fallback(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x), jcfg)
    np.testing.assert_allclose(ref.numpy(), np.asarray(jref), rtol=TOL,
                               atol=TOL)
    assert (out - ref).abs().max().item() < 1e-4
    assert aux.item() > 0


def test_capacity_drops_tokens_gracefully():
    jcfg, cfg = _cfgs()
    params = _params(jcfg)
    params["router"] = params["router"].copy()
    params["router"][:, 0] += 100.0     # one dominant expert for inputs
    x = np.abs(_x((2, 32, cfg.d_model)))  # whose entries sum positive
    out, _ = _both(params, x, jcfg, cfg, dropless=False)
    assert bool(torch.isfinite(out).all())
    out2, _ = _both(params, x, jcfg, cfg, dropless=True)
    assert (out - out2).abs().max().item() > 0
    # the capacities themselves are the reference's
    for T in (1, 7, 64, 256, 1000):
        assert MO.capacity(T, cfg) == JMO.capacity(T, jcfg)


def test_aux_loss_balanced_routing_is_minimal():
    jcfg, cfg = _cfgs()
    params = _params(jcfg)
    params["router"] = np.zeros_like(params["router"])
    x = np.abs(_x((4, 64, cfg.d_model)))   # entries that sum positive
    _, aux = _both(params, x, jcfg, cfg, dropless=False)
    K = cfg.experts_per_token
    assert K * 0.9 < aux.item() < K * 1.6
    params["router"] = params["router"].copy()
    params["router"][:, 0] += 100.0
    _, aux_bad = _both(params, x, jcfg, cfg, dropless=False)
    assert aux_bad.item() > aux.item()


def test_gate_normalization():
    jcfg, cfg = _cfgs()
    params = _params(jcfg)
    x = np.zeros((1, 4, cfg.d_model), np.float32)
    out, _ = _both(params, x, jcfg, cfg, dropless=True)
    assert out.abs().max().item() < 1e-3
    # the selected gates sum to 1 per token
    _, gates, _ = MO.route(_torch(params),
                           torch.tensor(_x((16, cfg.d_model))), cfg)
    np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, rtol=1e-6)


def test_shared_expert_contributes():
    jcfg, cfg = _cfgs()
    assert cfg.n_shared_experts == 1
    params = _params(jcfg)
    x = _x((1, 4, cfg.d_model))
    full, _ = _both(params, x, jcfg, cfg, dropless=True)
    p2 = dict(params)
    p2["shared"] = {k: np.zeros_like(v) for k, v in params["shared"].items()}
    nosh, _ = _both(p2, x, jcfg, cfg, dropless=True)
    assert (full - nosh).abs().max().item() > 1e-4


@pytest.mark.parametrize("name", ["kimi-k2-1t-a32b",
                                  "llama4-maverick-400b-a17b"])
def test_planted_routing_tie_picks_the_reference_experts(name):
    """Router columns 1 and 2 equal (and 0 and 3 equal to each other): every
    token's probabilities tie between them, and ``jax.lax.top_k`` takes
    the lower index. The port picks the same experts, so its output and
    its aux loss equal the reference's."""
    jcfg, cfg = _cfgs(name)
    params = _params(jcfg)
    r = params["router"].copy()
    r[:, 2] = r[:, 1]
    r[:, 3] = r[:, 0]
    params["router"] = r
    xt = _x((12, cfg.d_model))
    probs, _, ids = MO.route(_torch(params), torch.tensor(xt), cfg)
    assert torch.equal(probs[:, 1], probs[:, 2])
    _, jids = jax.lax.top_k(jax.nn.softmax(jnp.asarray(xt) @ r, axis=-1),
                            cfg.experts_per_token)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    for dropless in (True, False):
        _both(params, xt.reshape(2, 6, -1), jcfg, cfg, dropless)


@pytest.mark.parametrize("dropless", [True, False])
def test_per_row_groups_equal_the_reference_row_by_row(dropless):
    """``moe_per_row``: each row of x has its own capacity and ranks, as the
    reference's one-lane forward vmapped over lanes computes it; rows
    whose tokens overflow an expert drop within the row only. Held
    against the JAX op applied to each row alone (48 experts, top 1, a
    dominant expert, so capacities bind)."""
    jcfg, cfg = _cfgs(n_experts=48, experts_per_token=1)
    params = _params(jcfg)
    params["router"] = params["router"].copy()
    params["router"][:, 0] += 100.0
    x = np.abs(_x((3, 16, cfg.d_model)))
    got, _ = MO.apply_moe(_torch(params), torch.tensor(x), cfg,
                          dropless=dropless, moe_per_row=True)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    for i in range(x.shape[0]):
        want, _ = JMO.apply_moe(jp, jnp.asarray(x[i:i + 1]), jcfg,
                                dropless=dropless)
        np.testing.assert_allclose(got[i:i + 1].numpy(), np.asarray(want),
                                   rtol=TOL, atol=TOL)
    whole, _ = MO.apply_moe(_torch(params), torch.tensor(x), cfg,
                            dropless=dropless, moe_per_row=False)
    assert (whole - got).abs().max().item() > 0   # the grouping matters
