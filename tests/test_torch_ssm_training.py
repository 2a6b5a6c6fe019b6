"""Training on the recurrent-state configs, the port against the JAX
package on the CPU at ``ModelConfig.reduced()`` fp32, on shared params,
batches and draws: ``ar_loss`` on rwkv6, value and gradients through the
RWKV loops, with remat per period and without, then one AdamW step
(jamba's ``cdlm_loss``: ``tests/test_torch_jamba_training.py``, which
reuses these helpers); and the training CLI's family rules: an ``ssm`` config
trains ``ar`` whatever the stage, a ``hybrid`` config's ``cdlm`` teacher
trains block-causally, each run to its end at a tiny budget.
Limits: loss values within 1e-4 (the whole stack's limit,
``tests/test_torch_arch.py::REC_TOL``: depth compounds the summation
order); gradients within 1e-4 of each leaf's max|grad|; the AdamW step from the
reference's gradients, the updated params within lr * 1e-3 where |g| >
1e-6 max|g| (the first step is nearly sign(g) * lr)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro.configs.base import CDLMConfig as JaxCDLM  # noqa: E402
from repro.configs.base import TrainConfig as JaxTrain  # noqa: E402
from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.models import init_model  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.training import steps as JS  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import CDLMConfig, TrainConfig, get_config  # noqa: E402,E501
from repro_torch.core import masks  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.training import steps as S  # noqa: E402

torch.set_num_threads(2)

P, G, B = 8, 8, 4
VAL_TOL = 1e-4
GRAD_TOL = 1e-4
JAMBA, RWKV6 = "jamba-v0.1-52b", "rwkv6-1.6b"


def _configs(name):
    return (jax_get_config(name).reduced(dtype="float32"),
            get_config(name).reduced(dtype="float32"))


def _tree(jcfg, seed=0):
    return jax.tree_util.tree_map(np.asarray,
                                  init_model(jax.random.PRNGKey(seed), jcfg))


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(got, want, tol):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=0,
                               atol=tol)


def _jax_flat(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): np.asarray(leaf, np.float32)
            for path, leaf in flat}


def _port_flat(tree):
    out = {}
    for path, leaf in T.leaves_with_path(tree):
        key = T.key_path(path)
        x = leaf.detach().float().numpy()
        out[key] = x.T if key == "embed/head" else x
    return out


def _grads_close(got_tree, want_tree):
    got, want = _port_flat(got_tree), _jax_flat(want_tree)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(got[key], w, rtol=0,
                                   atol=GRAD_TOL * scale, err_msg=key)


def _jax_draws(key, b, G_):
    """The draws of the JAX losses' DLM term: (t, u) of split(key)."""
    k1, k2 = jax.random.split(key)
    t = jax.random.uniform(k1, (b,), minval=0.05, maxval=1.0)
    return {"t": _t(t), "u": _t(jax.random.uniform(k2, (b, G_)))}


def _one_adamw_step(tree, cfg, want_g):
    """One AdamW step from the reference's gradients on both sides: every
    leaf, the Mamba and RWKV ones and the fp32-pinned ones too, updated as
    the reference updates it."""
    tcfg = dict(learning_rate=1e-3, steps=2, weight_decay=0.1)
    jnew, _, _ = jadamw.update(want_g, jadamw.init(_jax(tree)), _jax(tree),
                               JaxTrain(**tcfg))
    params = params_from_jax(tree, cfg, "cpu")
    grads = params_from_jax(jax.tree_util.tree_map(np.asarray, want_g), cfg,
                            "cpu")
    new, _, m = adamw.update(grads, adamw.init(params), params,
                             TrainConfig(**tcfg))
    got, want, g = _port_flat(new), _jax_flat(jnew), _jax_flat(want_g)
    for key, w in want.items():
        big = np.abs(g[key]) > 1e-6 * np.abs(g[key]).max()
        np.testing.assert_allclose(got[key][big], w[big], rtol=0,
                                   atol=m["lr"] * 1e-3, err_msg=key)
        assert got[key].dtype == w.dtype
    assert any(not np.array_equal(got[k], v)
               for k, v in _jax_flat(tree).items())


def test_ar_loss_and_grads_match_jax_on_rwkv6():
    jcfg, cfg = _configs(RWKV6)
    tree = _tree(jcfg)
    rng = np.random.default_rng(1)
    nb = {"prompt": rng.integers(2, jcfg.vocab_size, (3, P)),
          "answer": rng.integers(2, jcfg.vocab_size, (3, G)),
          "maskable": np.arange(G)[None, :] <= np.array([G - 1, 3, 5])[:,
                                                                       None]}
    (want, _), want_g = jax.value_and_grad(JS.ar_loss, has_aux=True)(
        _jax(tree), {k: jnp.asarray(v) for k, v in nb.items()},
        jax.random.PRNGKey(0), cfg=jcfg)
    params = params_from_jax(tree, cfg, "cpu")
    batch = {k: _t(v) for k, v in nb.items()}
    for remat in (False, True):
        (got, gm), got_g = S.value_and_grad(
            lambda p: S.ar_loss(p, batch, cfg=cfg, remat=remat), params)
        _close(got, want, VAL_TOL)
        _grads_close(got_g, want_g)
    _one_adamw_step(tree, cfg, want_g)


@pytest.mark.parametrize("name,stage", [(JAMBA, "cdlm"), (RWKV6, "cdlm"),
                                        (RWKV6, "teacher")])
def test_train_cli_family_rules(name, stage, tmp_path, capsys, monkeypatch):
    """rwkv6 (``ssm``) trains the AR loss at any stage; jamba's (``hybrid``)
    ``cdlm`` teacher trains block-causally. Each run ends with a
    checkpoint the JAX package restores."""
    from repro_torch.launch import train
    from repro_torch.training import trainer
    modes = []
    real = trainer.train_teacher

    def spy(*a, **kw):
        modes.append(kw.get("mode", masks.BIDIRECTIONAL))
        return real(*a, **kw)

    monkeypatch.setattr(trainer, "train_teacher", spy)
    ckpt = str(tmp_path / "out.npz")
    train.main(["--arch", name, "--stage", stage, "--device", "cpu",
                "--steps", "1", "--student-steps", "1", "--batch-size", "8",
                "--ckpt", ckpt])
    out = capsys.readouterr().out
    assert f"saved -> {ckpt}" in out
    if name == RWKV6:
        assert modes == [] and "ar_loss=" in out
    else:
        assert modes == [masks.BLOCK_CAUSAL] and "distill=" in out
    jcfg, _ = _configs(name)
    back = jckpt.restore(init_model(jax.random.PRNGKey(0), jcfg), ckpt)
    assert all(np.isfinite(np.asarray(x)).all()
               for x in jax.tree_util.tree_leaves(back))
