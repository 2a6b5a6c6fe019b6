"""The trainer's paths with request extras, the port against the JAX
package at ``reduced()`` fp32 (``_torch_extras.py``), on shared params,
batch, extras and draws: ``cdlm_loss`` of whisper-base with frame
embeddings (the encoder in each of its three forwards) and of
internvl2-1b with a prefix (which shifts the prompt length and the
generation span's rows; with and without ``efficient_loss``), its value,
its distillation, consistency and DLM terms and every gradient (the
encoder's and the cross attention's leaves too); and the greedy
trajectory collector (``trajectory.collect``), which refuses a prefix:
the reference's collector cannot decode one (its collection with
whisper's frames: ``tests/test_torch_whisper.py``).
Values within 1e-4, gradients within 1e-4 of each leaf's max|grad|, as
``tests/test_torch_ssm_training.py``'s limits; trajectories exactly,
hidden states within 1e-4."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_extras import (  # noqa: E402
    INTERNVL,
    WHISPER,
    extras,
    setup,
    to_jax,
    to_torch,
)
from repro.configs.base import CDLMConfig as JaxCDLM  # noqa: E402
from repro.training import steps as JS  # noqa: E402
from repro_torch.configs import CDLMConfig  # noqa: E402
from repro_torch.core import trajectory as traj  # noqa: E402
from repro_torch.training import steps as S  # noqa: E402
from test_torch_jamba_training import _cdlm_batch  # noqa: E402
from test_torch_ssm_training import (  # noqa: E402
    GRAD_TOL,
    VAL_TOL,
    _close,
    _grads_close,
    _jax_draws,
    _t,
)

torch.set_num_threads(2)

P, G, B = 8, 8, 4
assert GRAD_TOL == VAL_TOL == 1e-4


@pytest.mark.parametrize("name, efficient", [(WHISPER, False),
                                             (INTERNVL, False),
                                             (INTERNVL, True)])
def test_cdlm_loss_and_grads_with_extras(name, efficient):
    s = setup(name, head_scale=1.0)
    nb = _cdlm_batch(s.jcfg)
    ex = extras(s.cfg, 2, seed=7)
    key = jax.random.PRNGKey(1)
    jcdlm = JaxCDLM(block_size=B, gen_length=G, prompt_length=P)
    cdlm = CDLMConfig(block_size=B, gen_length=G, prompt_length=P)
    (want, wm), want_g = jax.value_and_grad(JS.cdlm_loss, has_aux=True)(
        s.jparams, None, {k: jnp.asarray(v) for k, v in nb.items()}, key,
        cfg=s.jcfg, cdlm=jcdlm, teacher_head=s.jparams["embed"],
        use_lora=False, extras=to_jax(ex), efficient_loss=efficient)
    batch = {k: _t(v) for k, v in nb.items()}
    head = {k: v.detach() for k, v in s.params["embed"].items()}
    (got, gm), got_g = S.value_and_grad(
        lambda p: S.cdlm_loss(p, None, batch, _jax_draws(key, 2, G),
                              cfg=s.cfg, cdlm=cdlm, teacher_head=head,
                              use_lora=False, extras=to_torch(ex),
                              efficient_loss=efficient), s.params)
    _close(got, want, VAL_TOL)
    for term in ("distill", "cons", "dlm"):
        _close(gm[term], wm[term], VAL_TOL)
    _grads_close(got_g, want_g)
    if name == WHISPER:
        assert got_g["encoder"]["slots"][0]["attn"]["wq"].abs().max() > 0
        assert got_g["slots"][0]["cross"]["wk"].abs().max() > 0


def test_collector_refuses_a_prefix():
    """The reference's ``collect`` builds its decode's spec without a
    ``pos_offset``, so a prefix breaks its canvas coordinates; the port
    refuses one."""
    s = setup(INTERNVL)
    cdlm = CDLMConfig(block_size=B, gen_length=G, prompt_length=P,
                      temperatures=(0.0,))
    with pytest.raises(ValueError, match="takes no prefix_embeds"):
        traj.collect(s.params, torch.zeros((2, P), dtype=torch.int64),
                     torch.zeros((2, G), dtype=torch.int64), cfg=s.cfg,
                     cdlm=cdlm, extras=to_torch(extras(s.cfg, 2)))
