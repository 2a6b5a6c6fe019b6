"""``cdlm_loss`` on jamba, the port against the JAX package on the CPU at
``ModelConfig.reduced()`` fp32, on shared params, batch and draws: the
student's own embedding as the teacher head, as the reference's
``tests/test_arch_smoke.py`` trains it; the value, its distillation,
consistency, DLM and MoE aux terms and every gradient, through the Mamba
loops and the MoE slots, with remat per period equal to without; then
one AdamW step. Limits as ``tests/test_torch_ssm_training.py``'s (whose
helpers this reuses): values within 1e-4 (jamba's 16 reduced layers
compound the summation order), gradients within 1e-4 of each leaf's
max|grad|. The reference's gradient takes ~85 s to compile here, so the
test has a file of its own."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import CDLMConfig as JaxCDLM  # noqa: E402
from repro.training import steps as JS  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import CDLMConfig  # noqa: E402
from repro_torch.training import steps as S  # noqa: E402
from test_torch_ssm_training import (  # noqa: E402
    GRAD_TOL,
    JAMBA,
    VAL_TOL,
    _close,
    _configs,
    _grads_close,
    _jax,
    _jax_draws,
    _one_adamw_step,
    _port_flat,
    _t,
    _tree,
)

torch.set_num_threads(2)

P, G, B = 8, 8, 4
assert GRAD_TOL == VAL_TOL == 1e-4


def _cdlm_batch(jcfg, b=2, seed=0):
    """The reference smoke test's batch: a student canvas and its target
    canvas, one unmasked and one still-masked position, the teacher's
    hidden states, the ground truth and the prompt."""
    rng = np.random.default_rng(seed)

    def tok(*s):
        return rng.integers(2, jcfg.vocab_size, s)

    u_mask = np.zeros((b, P + G), bool)
    u_mask[:, P + 1] = True
    s_mask = np.zeros((b, P + G), bool)
    s_mask[:, P + 5] = True
    return {"y": tok(b, P + G), "y_star": tok(b, P + G), "u_mask": u_mask,
            "s_mask": s_mask,
            "teacher_hidden": (0.1 * rng.standard_normal(
                (b, G, jcfg.d_model))).astype(np.float32),
            "gt": tok(b, G), "prompt": tok(b, P)}


def test_cdlm_loss_and_grads_match_jax_on_jamba():
    jcfg, cfg = _configs(JAMBA)
    tree = _tree(jcfg)
    nb = _cdlm_batch(jcfg)
    key = jax.random.PRNGKey(1)
    jcdlm = JaxCDLM(block_size=B, gen_length=G, prompt_length=P)
    cdlm = CDLMConfig(block_size=B, gen_length=G, prompt_length=P)
    jp = _jax(tree)
    (want, wm), want_g = jax.value_and_grad(JS.cdlm_loss, has_aux=True)(
        jp, None, {k: jnp.asarray(v) for k, v in nb.items()}, key,
        cfg=jcfg, cdlm=jcdlm, teacher_head=jp["embed"], use_lora=False)
    params = params_from_jax(tree, cfg, "cpu")
    batch = {k: _t(v) for k, v in nb.items()}
    head = {k: v.detach() for k, v in params["embed"].items()}
    grads = []
    for remat in (False, True):
        (got, gm), got_g = S.value_and_grad(
            lambda p: S.cdlm_loss(p, None, batch, _jax_draws(key, 2, G),
                                  cfg=cfg, cdlm=cdlm, teacher_head=head,
                                  use_lora=False, remat=remat), params)
        _close(got, want, VAL_TOL)
        for name in ("distill", "cons", "dlm", "aux"):
            _close(gm[name], wm[name], VAL_TOL)
        assert float(gm["aux"]) > 0          # the MoE slots' balance loss
        _grads_close(got_g, want_g)
        grads.append(_port_flat(got_g))
    for key_, g in grads[0].items():        # remat recomputes the loops
        np.testing.assert_allclose(grads[1][key_], g, rtol=0,
                                   atol=1e-6 * max(np.abs(g).max(), 1e-30),
                                   err_msg=key_)
    _one_adamw_step(tree, cfg, want_g)
