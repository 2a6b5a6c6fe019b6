"""The port's training slice against the JAX package's, on shared inputs
and shared draws (the JAX ``jax.random`` bits are handed to the port's
pure counterparts: ``mask_tokens_from``, ``training_pair``, the DLM draws,
the LoRA tree): masking, every loss, the trajectory state algebra, the
forward's ``logits_slice`` and ``remat``, the three training losses with
their gradients (``jax.value_and_grad`` of the reference), one AdamW
update, the LoRA merge, checkpoints both ways, the collector (greedy, and
at the augmentation temperatures (0.0, 0.5)), the train CLI, and the refusal of the attention kernels under autograd.

Limits: loss values within 1e-5 (fp32, sums in another order); gradients
within 1e-4 of each leaf's max|grad|; collected tokens and step indices
exactly; the hidden buffer within 1e-4; AdamW moments within 1e-6
relative, updated params within lr * 1e-3 where |g| > 1e-6 max|g| (the
first step is nearly sign(g) * lr, so a gradient at the rounding floor can
flip)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro.configs.base import CDLMConfig as JaxCDLM  # noqa: E402
from repro.configs.base import TrainConfig as JaxTrain  # noqa: E402
from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.core import diffusion as jdiff  # noqa: E402
from repro.core import losses as JLS  # noqa: E402
from repro.core import trajectory as jtraj  # noqa: E402
from repro.models import forward as jax_forward  # noqa: E402
from repro.models import init_model  # noqa: E402
from repro.models import lora as jlora  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.training import steps as JS  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.bridge import lora_from_jax, params_from_jax  # noqa: E402
from repro_torch.checkpoint import restore, save  # noqa: E402
from repro_torch.configs import CDLMConfig, TrainConfig, get_config  # noqa: E402,E501
from repro_torch.core import diffusion as D  # noqa: E402
from repro_torch.core import losses as LS  # noqa: E402
from repro_torch.core import masks  # noqa: E402
from repro_torch.core import trajectory as traj  # noqa: E402
from repro_torch.data import Corpus, TaskSpec  # noqa: E402
from repro_torch.kernels.block_attn import flash_block_attention  # noqa: E402
from repro_torch.kernels.decode_attn import (  # noqa: E402
    decode_attention,
    paged_decode_attention,
)
from repro_torch.kernels.select import fused_select  # noqa: E402
from repro_torch.models import forward  # noqa: E402
from repro_torch.models import lora  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.training import steps as S  # noqa: E402
from repro_torch.training import trainer  # noqa: E402

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False

P, G, B = 6, 8, 4
VAL_TOL = 1e-5
GRAD_TOL = 1e-4


def _configs(name="qwen2-0.5b"):
    return (jax_get_config(name).reduced(dtype="float32"),
            get_config(name).reduced(dtype="float32"))


def _np_params(jcfg, seed=0):
    tree = jax.tree_util.tree_map(np.asarray,
                                  init_model(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    attn = tree["slots"][0]["attn"]
    for name in ("bq", "bk", "bv"):
        if name in attn:
            attn[name] = rng.normal(0, 0.1, attn[name].shape).astype(
                np.float32)
    return tree


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


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


def _close(got, want, tol):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=0,
                               atol=tol)


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


def _batch(jcfg, b=3, seed=0):
    rng = np.random.default_rng(seed)
    prompt = rng.integers(2, jcfg.vocab_size - 1, (b, P))
    answer = rng.integers(2, jcfg.vocab_size - 1, (b, G))
    maskable = np.arange(G)[None, :] <= np.array([G - 1, 3, 5])[:b, None]
    return {"prompt": prompt, "answer": answer, "maskable": maskable}


# ---------------------------------------------------------------------------
# masking, losses
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("with_maskable", [False, True])
def test_mask_tokens_given_u_matches_jax(with_maskable):
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 100, (4, 12))
    t = np.array([0.1, 0.5, 0.9, 1.0], np.float32)
    maskable = rng.random((4, 12)) < 0.7 if with_maskable else None
    key = jax.random.PRNGKey(3)
    want, want_m = jdiff.mask_tokens(key, jnp.asarray(tokens), jnp.asarray(t),
                                     99, None if maskable is None
                                     else jnp.asarray(maskable))
    u = jax.random.uniform(key, tokens.shape)
    got, got_m = D.mask_tokens_from(_t(u), _t(tokens), _t(t), 99,
                                    None if maskable is None
                                    else _t(maskable))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    gen = torch.Generator().manual_seed(0)
    again, m = D.mask_tokens(gen, _t(tokens), _t(t), 99)
    assert again.shape == tokens.shape and m.dtype == torch.bool


def _loss_inputs(seed=0, b=3, L_=8, V=64):
    rng = np.random.default_rng(seed)
    p = rng.normal(0, 2, (b, L_, V)).astype(np.float32)
    q = rng.normal(0, 2, (b, L_, V)).astype(np.float32)
    mask = rng.random((b, L_)) < 0.5
    mask[1] = False                      # an example with no position
    return p, q, mask


@pytest.mark.parametrize("name,direction", [
    ("distillation_loss", "forward"), ("distillation_loss", "reverse"),
    ("consistency_loss", "forward"), ("consistency_loss", "reverse")])
def test_kl_losses_and_grads_match_jax(name, direction):
    p, q, mask = _loss_inputs()

    def jfn(student):
        return getattr(JLS, name)(student, jnp.asarray(p), jnp.asarray(mask),
                                  direction)

    want, want_g = jax.value_and_grad(jfn)(jnp.asarray(q))
    ts = _t(q).requires_grad_()
    target = _t(p).requires_grad_()
    got = getattr(LS, name)(ts, target, _t(mask), direction)
    g_student, g_target = torch.autograd.grad(got, (ts, target),
                                              allow_unused=True)
    _close(got, want, VAL_TOL)
    _close(g_student, want_g, GRAD_TOL * float(jnp.abs(want_g).max()))
    # the teacher / y* side is detached, as the reference's stop_gradient
    assert g_target is None


def test_plain_losses_match_jax():
    p, q, mask = _loss_inputs(1)
    rng = np.random.default_rng(1)
    _close(LS.forward_kl(_t(p), _t(q)), JLS.forward_kl(p, q), VAL_TOL)
    _close(LS.reverse_kl(_t(p), _t(q)), JLS.reverse_kl(p, q), VAL_TOL)
    per = rng.normal(0, 1, mask.shape).astype(np.float32)
    _close(LS._masked_mean(_t(per), _t(mask)),
           JLS._masked_mean(jnp.asarray(per), jnp.asarray(mask)), VAL_TOL)
    _close(LS._masked_mean(_t(per), _t(np.zeros_like(mask))), 0.0, 0)
    targets = rng.integers(0, 64, mask.shape)
    t = np.array([0.5, 0.0, 0.9], np.float32)       # t = 0 clamps to 1e-3
    _close(LS.dlm_loss(_t(p), _t(targets), _t(mask), _t(t)),
           JLS.dlm_loss(jnp.asarray(p), jnp.asarray(targets),
                        jnp.asarray(mask), jnp.asarray(t)), VAL_TOL)
    w = dict(w_distill=1.0, w_cons=0.5, w_dlm=0.01)
    assert LS.cdlm_total(1.5, 2.0, 3.0, **w) == pytest.approx(
        float(JLS.cdlm_total(1.5, 2.0, 3.0, **w)))


def test_dlm_loss_from_hidden_equals_the_logits_dlm_loss():
    """The hidden-based DLM term (fused cross-entropy) against the JAX
    ``dlm_loss`` of ``hidden @ W.T``: value and grads for hidden and W."""
    rng = np.random.default_rng(2)
    b, d, V = 3, 32, 593
    h = rng.normal(0, 1, (b, G, d)).astype(np.float32)
    w = rng.normal(0, 0.3, (V, d)).astype(np.float32)
    targets = rng.integers(0, V, (b, G))
    masked = rng.random((b, G)) < 0.5
    t = np.array([0.3, 0.7, 0.05], np.float32)

    def jfn(hh, ww):
        return JLS.dlm_loss(jnp.einsum("bgd,vd->bgv", hh, ww),
                            jnp.asarray(targets), jnp.asarray(masked),
                            jnp.asarray(t))

    want, (gh, gw) = jax.value_and_grad(jfn, (0, 1))(jnp.asarray(h),
                                                      jnp.asarray(w))
    th, tw = _t(h).requires_grad_(), _t(w).requires_grad_()
    got = LS.dlm_loss_from_hidden(th, tw, _t(targets), _t(masked), _t(t))
    dh, dw = torch.autograd.grad(got, (th, tw))
    _close(got, want, VAL_TOL)
    _close(dh, gh, GRAD_TOL * float(jnp.abs(gh).max()))
    _close(dw, gw, GRAD_TOL * float(jnp.abs(gw).max()))


# ---------------------------------------------------------------------------
# trajectory algebra
# ---------------------------------------------------------------------------
def _dataset(jcfg, n=5, seed=0, d=None):
    """Monotone trajectories as Alg. 1 stores them: block b's positions
    finalized at steps [bB, (b+1)B) in a shuffled order."""
    rng = np.random.default_rng(seed)
    fat = np.concatenate([np.stack([rng.permutation(B) + blk * B
                                    for _ in range(n)])
                          for blk in range(G // B)], axis=1).astype(np.int32)
    return {"prompt": rng.integers(2, jcfg.vocab_size - 1, (n, P)),
            "gt": rng.integers(2, jcfg.vocab_size - 1, (n, G)),
            "final": rng.integers(2, jcfg.vocab_size - 1, (n, G)),
            "finalized_at": fat,
            "hidden": rng.normal(0, 1, (n, G, d or jcfg.d_model)).astype(
                np.float32)}


def _jax_pair(ds, key, bs, jcfg, jcdlm):
    """The JAX pair and the (idx, t_start) draws it used."""
    k1, k2 = jax.random.split(key)
    idx = jax.random.randint(k1, (bs,), 0, ds["final"].shape[0])
    t_start = jax.random.randint(k2, (bs,), 0, jcdlm.gen_length)
    pair = jtraj.sample_training_pair(
        {k: jnp.asarray(v) for k, v in ds.items()}, key, bs, cfg=jcfg,
        cdlm=jcdlm)
    return pair, np.asarray(idx), np.asarray(t_start)


def test_state_at_and_position_sets_match_jax():
    jcfg, cfg = _configs()
    ds = _dataset(jcfg)
    fin, fat = ds["final"], ds["finalized_at"]
    fat[0, 2] = -1                       # a position never finalized
    for step in (0, 3, np.array([1, 4, 7, 8, 2])):
        np.testing.assert_array_equal(
            traj.state_at(_t(fin), _t(fat), _t(step), 511).numpy(),
            np.asarray(jtraj.state_at(jnp.asarray(fin), jnp.asarray(fat),
                                      jnp.asarray(step), 511)))
    t_start = np.array([0, 3, 4, 6, 7])
    t_end = np.minimum(np.asarray(jtraj.block_completion_step(
        jnp.asarray(t_start), B)), G)
    np.testing.assert_array_equal(
        traj.block_completion_step(_t(t_start), B).clamp_max(G).numpy(),
        t_end)
    for got, want in zip(traj.position_sets(_t(fat), _t(t_start), _t(t_end)),
                         jtraj.position_sets(jnp.asarray(fat),
                                             jnp.asarray(t_start),
                                             jnp.asarray(t_end))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_training_pair_given_draws_matches_jax():
    jcfg, cfg = _configs()
    jcdlm = JaxCDLM(block_size=B, gen_length=G, prompt_length=P)
    cdlm = CDLMConfig(block_size=B, gen_length=G, prompt_length=P)
    ds = _dataset(jcfg)
    want, idx, t_start = _jax_pair(ds, jax.random.PRNGKey(7), 6, jcfg, jcdlm)
    got = traj.training_pair({k: _t(v) for k, v in ds.items()}, _t(idx),
                             _t(t_start), cfg=cfg, cdlm=cdlm)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    gen = torch.Generator().manual_seed(0)
    drawn = traj.sample_training_pair({k: _t(v) for k, v in ds.items()}, gen,
                                      4, cfg=cfg, cdlm=cdlm)
    assert drawn["y"].shape == (4, P + G)


# ---------------------------------------------------------------------------
# forward: logits_slice, remat
# ---------------------------------------------------------------------------
def test_forward_logits_slice_matches_jax_and_the_full_head():
    jcfg, cfg = _configs()
    tree = _np_params(jcfg)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, P + G))
    kw = dict(mode=masks.BLOCK_CAUSAL, prompt_len=P, block_size=B)
    want = jax_forward(_jax(tree), jnp.asarray(tokens), cfg=jcfg,
                       logits_slice=(P, P + G), **kw)
    params = params_from_jax(tree, cfg, "cpu")
    got = forward(params, _t(tokens), cfg=cfg, device="cpu",
                  logits_slice=(P, P + G), **kw)
    full = forward(params, _t(tokens), cfg=cfg, device="cpu", **kw)
    assert got.logits.shape == (2, G, cfg.vocab_size)
    _close(got.logits, want.logits, 1e-4)
    torch.testing.assert_close(got.logits, full.logits[:, P:])


def test_remat_gives_the_same_grads():
    jcfg, cfg = _configs()
    params = params_from_jax(_np_params(jcfg), cfg, "cpu")
    tokens = _t(np.random.default_rng(2).integers(0, cfg.vocab_size,
                                                  (2, P + G)))
    grads = []
    for remat in (False, True):
        (loss, _), g = S.value_and_grad(
            lambda p: (forward(p, tokens, cfg=cfg, device="cpu",
                               remat=remat).logits.square().mean(), {}),
            params)
        grads.append((loss, _port_flat(g)))
    assert torch.equal(grads[0][0], grads[1][0])
    for key, g in grads[0][1].items():
        np.testing.assert_allclose(grads[1][1][key], g, rtol=0,
                                   atol=1e-6 * max(np.abs(g).max(), 1e-30),
                                   err_msg=key)


# ---------------------------------------------------------------------------
# the training losses against jax.value_and_grad
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", [masks.BIDIRECTIONAL, masks.BLOCK_CAUSAL])
def test_dlm_pretrain_loss_matches_jax(mode):
    """The port feeds hidden[:, P:] through the fused cross-entropy where
    the reference slices full-canvas logits: the same loss and grads."""
    jcfg, cfg = _configs()
    tree = _np_params(jcfg)
    nb = _batch(jcfg)
    key = jax.random.PRNGKey(11)
    (want, wm), want_g = jax.value_and_grad(JS.dlm_pretrain_loss,
                                            has_aux=True)(
        _jax(tree), {k: jnp.asarray(v) for k, v in nb.items()}, key,
        cfg=jcfg, mode=mode, block_size=B)
    params = params_from_jax(tree, cfg, "cpu")
    batch = {k: _t(v) for k, v in nb.items()}
    (got, gm), got_g = S.value_and_grad(
        lambda p: S.dlm_pretrain_loss(p, batch, _jax_draws(key, 3, G),
                                      cfg=cfg, mode=mode, block_size=B),
        params)
    _close(got, want, VAL_TOL)
    _close(gm["dlm_loss"], wm["dlm_loss"], VAL_TOL)
    assert float(gm["aux"]) == float(wm["aux"]) == 0.0
    _grads_close(got_g, want_g)


def test_ar_loss_matches_jax():
    jcfg, cfg = _configs("dream-7b")            # untied head
    tree = _np_params(jcfg)
    nb = _batch(jcfg, seed=1)
    (want, _), want_g = jax.value_and_grad(JS.ar_loss, has_aux=True)(
        _jax(tree), {k: jnp.asarray(v) for k, v in nb.items()},
        jax.random.PRNGKey(0), cfg=jcfg)
    params = params_from_jax(tree, cfg, "cpu")
    (got, gm), got_g = S.value_and_grad(
        lambda p: S.ar_loss(p, {k: _t(v) for k, v in nb.items()}, cfg=cfg),
        params)
    _close(got, want, VAL_TOL)
    assert set(gm) == {"ar_loss", "aux"}
    _grads_close(got_g, want_g)


def _lora_pair(tree, seed=0, rank=4):
    """A JAX LoRA tree with nonzero b (so that a has a gradient)."""
    lt = jlora.init_lora(jax.random.PRNGKey(seed), _jax(tree), rank=rank)
    rng = np.random.default_rng(seed)
    return {k: {"a": np.asarray(v["a"]),
                "b": rng.normal(0, 0.05, v["b"].shape).astype(np.float32)}
            for k, v in lt.items()}


@pytest.mark.parametrize("use_lora", [False, True], ids=["full", "lora"])
@pytest.mark.parametrize("efficient", [False, True],
                         ids=["logits", "efficient"])
def test_cdlm_loss_matches_jax(use_lora, efficient):
    jcfg, cfg = _configs()
    jcdlm = JaxCDLM(block_size=B, gen_length=G, prompt_length=P)
    cdlm = CDLMConfig(block_size=B, gen_length=G, prompt_length=P)
    student, teacher = _np_params(jcfg, 0), _np_params(jcfg, 1)
    ds = _dataset(jcfg, seed=2)
    jbatch, _, _ = _jax_pair(ds, jax.random.PRNGKey(5), 3, jcfg, jcdlm)
    key = jax.random.PRNGKey(13)
    rank, alpha = 4, 8.0
    lt = _lora_pair(student) if use_lora else None
    jtrain = _jax(lt) if use_lora else _jax(student)
    (want, wm), want_g = jax.value_and_grad(JS.cdlm_loss, has_aux=True)(
        jtrain, _jax(student), jbatch, key, cfg=jcfg, cdlm=jcdlm,
        teacher_head=_jax(teacher["embed"]), use_lora=use_lora,
        lora_rank=rank, lora_alpha=alpha, efficient_loss=efficient)
    params = params_from_jax(student, cfg, "cpu")
    train = lora_from_jax(lt, "cpu") if use_lora else params
    batch = {k: _t(v) for k, v in jbatch.items()}
    head = params_from_jax(teacher, cfg, "cpu")["embed"]
    (got, gm), got_g = S.value_and_grad(
        lambda p: S.cdlm_loss(p, params, batch, _jax_draws(key, 3, G),
                              cfg=cfg, cdlm=cdlm, teacher_head=head,
                              use_lora=use_lora, lora_rank=rank,
                              lora_alpha=alpha, efficient_loss=efficient),
        train)
    _close(got, want, VAL_TOL)
    for name in ("distill", "cons", "dlm"):
        _close(gm[name], wm[name], VAL_TOL)
    _grads_close(got_g, want_g)


def test_softcapped_config_is_refused():
    jcfg, cfg = _configs()
    params = params_from_jax(_np_params(jcfg), cfg, "cpu")
    capped = dataclasses.replace(cfg, final_logit_softcap=30.0)
    batch = {k: _t(v) for k, v in _batch(jcfg).items()}
    with pytest.raises(ValueError, match="softcap"):
        S.ar_loss(params, batch, cfg=capped)


# ---------------------------------------------------------------------------
# AdamW, LoRA, checkpoints
# ---------------------------------------------------------------------------
def test_adamw_update_matches_jax():
    """Clipping engaged (grad norm >> 1), weight decay on: the same leaves
    decayed (the reference's substring rule), moments, step, lr."""
    jcfg, cfg = _configs()
    tree = _np_params(jcfg)
    rng = np.random.default_rng(4)
    gtree = jax.tree_util.tree_map(
        lambda a: rng.normal(0, 3, a.shape).astype(np.float32), tree)
    tcfg = dict(learning_rate=1e-2, steps=10, warmup_frac=0.3,
                weight_decay=0.1, grad_clip=1.0)
    jparams, jstate, jm = jadamw.update(_jax(gtree), jadamw.init(_jax(tree)),
                                        _jax(tree), JaxTrain(**tcfg))
    params = params_from_jax(tree, cfg, "cpu")
    grads = params_from_jax(gtree, cfg, "cpu")
    new, state, m = adamw.update(grads, adamw.init(params), params,
                                 TrainConfig(**tcfg))
    assert state.step == int(jstate.step) == 1
    assert m["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
    _close(m["grad_norm"], jm["grad_norm"], 1e-4 * float(jm["grad_norm"]))
    assert float(m["grad_norm"]) > 100 * tcfg["grad_clip"]
    # the decay decisions, leaf for leaf, on the same path strings
    jdecay = {}
    jax.tree_util.tree_map_with_path(
        lambda p, x: jdecay.setdefault(
            "/".join(str(getattr(q, "key", getattr(q, "idx", q)))
                     for q in p), not jadamw._no_decay(p)), _jax(tree))
    decay = {T.key_path(p): not adamw._no_decay(p)
             for p, _ in T.leaves_with_path(params)}
    assert decay == jdecay
    assert not decay["embed/tok"] and not decay["slots/0/mlp/wi_up"]
    assert decay["slots/0/attn/wq"]
    for got_t, want_t in ((state.m, jstate.m), (state.v, jstate.v)):
        got, want = _port_flat(got_t), _jax_flat(want_t)
        for key, w in want.items():
            np.testing.assert_allclose(got[key], w, rtol=1e-6, atol=1e-12,
                                       err_msg=key)
    got, want, g = _port_flat(new), _jax_flat(jparams), _jax_flat(gtree)
    for key, w in want.items():
        big = np.abs(g[key]) > 1e-6 * np.abs(g[key]).max()
        np.testing.assert_allclose(got[key][big], w[big], rtol=0,
                                   atol=m["lr"] * 1e-3, err_msg=key)


@pytest.mark.parametrize("schedule", ["constant", "cosine"])
def test_lr_schedules_match_jax(schedule):
    kw = dict(learning_rate=3e-3, steps=40, warmup_frac=0.1,
              lr_schedule=schedule)
    mine, theirs = adamw.make_lr_fn(TrainConfig(**kw)), \
        jadamw.make_lr_fn(JaxTrain(**kw))
    for step in (0, 1, 3, 4, 5, 20, 39, 40, 60):
        assert mine(step) == pytest.approx(float(theirs(jnp.asarray(step))),
                                           rel=1e-6, abs=1e-12)


def test_lora_init_and_merge_match_jax():
    jcfg, cfg = _configs()
    tree = _np_params(jcfg)
    jl = jlora.init_lora(jax.random.PRNGKey(0), _jax(tree), rank=4)
    params = params_from_jax(tree, cfg, "cpu")
    # the JAX a's, unscaled, are the draws of the pure counterpart
    draws = {k: _t(np.asarray(v["a"]) * np.sqrt(v["a"].shape[-2]))
             for k, v in jl.items()}
    mine = lora.lora_from_draws(params, draws, rank=4)
    assert sorted(mine) == sorted(jl)
    for k, v in jl.items():
        _close(mine[k]["a"], v["a"], 1e-6)
        np.testing.assert_array_equal(mine[k]["b"].numpy(), np.asarray(v["b"]))
    drawn = lora.init_lora(torch.Generator().manual_seed(0), params, rank=4)
    assert {k: tuple(v["a"].shape) for k, v in drawn.items()} == \
        {k: tuple(v["a"].shape) for k, v in jl.items()}
    assert lora.param_count(drawn) == jlora.param_count(jl)
    lt = _lora_pair(tree)
    want = jlora.merge(_jax(tree), _jax(lt), 8.0, 4)
    got = lora.merge(params, lora_from_jax(lt, "cpu"), 8.0, 4)
    for key, w in _jax_flat(want).items():
        np.testing.assert_allclose(_port_flat(got)[key], w, rtol=0,
                                   atol=1e-6, err_msg=key)


@pytest.mark.parametrize("name", ["qwen2-0.5b", "dream-7b"],
                         ids=["tied", "untied"])
def test_checkpoint_round_trips_both_ways(name, tmp_path):
    jcfg, cfg = _configs(name)
    tree = _np_params(jcfg)
    params = params_from_jax(tree, cfg, "cpu")
    # port -> JAX
    save(params, str(tmp_path / "port.npz"))
    back = jckpt.restore(_jax(tree), str(tmp_path / "port.npz"))
    for key, w in _jax_flat(back).items():
        np.testing.assert_array_equal(w, _jax_flat(tree)[key], err_msg=key)
    # JAX -> port, into a template of other values
    jckpt.save(_jax(tree), str(tmp_path / "jax.npz"))
    template = T.tree_map(torch.zeros_like, params)
    got = restore(template, str(tmp_path / "jax.npz"))
    for key, w in _port_flat(params).items():
        np.testing.assert_array_equal(_port_flat(got)[key], w, err_msg=key)
    # a LoRA tree keeps its "slots/0/attn/wq/a" keys
    lt = lora_from_jax(_lora_pair(tree), "cpu")
    save(lt, str(tmp_path / "lora.npz"))
    with np.load(tmp_path / "lora.npz") as data:
        assert "slots/0/attn/wq/a" in data
    back = restore(T.tree_map(torch.zeros_like, lt), str(tmp_path /
                                                         "lora.npz"))
    assert all(torch.equal(a, b) for a, b in zip(T.leaves(back),
                                                 T.leaves(lt)))


def test_bf16_checkpoint_from_jax_reads_exactly(tmp_path):
    jcfg, cfg = _configs()
    tree = _np_params(jcfg)
    jtree = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                   tree)
    jckpt.save(jtree, str(tmp_path / "bf16.npz"))
    template = T.tree_map(lambda x: torch.zeros_like(x, dtype=torch.bfloat16),
                          params_from_jax(tree, cfg, "cpu"))
    got = restore(template, str(tmp_path / "bf16.npz"))
    for key, w in _jax_flat(jtree).items():
        np.testing.assert_array_equal(_port_flat(got)[key], w, err_msg=key)
    save(got, str(tmp_path / "again.npz"))
    back = jckpt.restore(jtree, str(tmp_path / "again.npz"))
    for key, w in _jax_flat(back).items():
        np.testing.assert_array_equal(w, _jax_flat(jtree)[key], err_msg=key)


# ---------------------------------------------------------------------------
# the greedy collector (Alg. 1 at τ = 0)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fused", [False, True], ids=["logits", "fused"])
def test_greedy_collector_matches_jax(fused):
    jcfg, cfg = _configs()
    tree = _np_params(jcfg)
    rng = np.random.default_rng(5)
    prompts = rng.integers(2, cfg.vocab_size - 1, (3, P))
    gt = rng.integers(2, cfg.vocab_size - 1, (3, G))
    jcdlm = JaxCDLM(block_size=B, gen_length=G, prompt_length=P,
                    temperatures=(0.0,))
    cdlm = CDLMConfig(block_size=B, gen_length=G, prompt_length=P,
                      temperatures=(0.0,))
    want = jtraj.collect(_jax(tree), jnp.asarray(prompts), jnp.asarray(gt),
                         cfg=jcfg, cdlm=jcdlm, key=jax.random.PRNGKey(0))
    got = traj.collect(params_from_jax(tree, cfg, "cpu"), _t(prompts),
                       _t(gt), cfg=cfg, cdlm=cdlm, fused_select=fused)
    for k in ("prompt", "gt", "final", "finalized_at"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    assert got["finalized_at"].dtype == torch.int32
    assert got["hidden"].dtype == torch.float32
    _close(got["hidden"], want["hidden"], 1e-4)


@pytest.mark.parametrize("fused", [False, True], ids=["logits", "fused"])
def test_collector_step_replays_the_trajectory(fused):
    """Each step of a collected trajectory, replayed from its canvas
    ``state_at(final, finalized_at, s)`` through ``top1_step`` (what the
    card's smoke run holds the kernel-collected data against), finalizes
    the recorded position with the recorded token and hidden state."""
    from repro_torch.core.block_loop import SamplerSpec, top1_step
    from repro_torch.models import unembed_matrix
    _, cfg = _configs()
    params = params_from_jax(_np_params(_configs()[0]), cfg, "cpu")
    rng = np.random.default_rng(6)
    prompts = _t(rng.integers(2, cfg.vocab_size - 1, (3, P)))
    cdlm = CDLMConfig(block_size=B, gen_length=G, prompt_length=P,
                      temperatures=(0.0,))
    ds = traj.collect(params, prompts, torch.zeros((3, G), dtype=torch.int64),
                      cfg=cfg, cdlm=cdlm, fused_select=True)
    spec = SamplerSpec(prompt_len=P, gen_len=G, block_size=B,
                       fused_select=fused)
    w = unembed_matrix(params, cfg) if fused else None
    lanes = torch.arange(3)
    with torch.no_grad():
        for s in range(G):
            g0 = s // B * B
            canvas = torch.cat([prompts, traj.state_at(
                ds["final"], ds["finalized_at"], s, cfg.mask_token_id)], 1)
            cand, conf, hidden = top1_step(params, canvas, P + g0, cfg=cfg,
                                           spec=spec, w=w)
            p = conf.argmax(-1)
            np.testing.assert_array_equal(
                ds["finalized_at"][lanes, g0 + p].numpy(), s)
            np.testing.assert_array_equal(
                cand[lanes, p].numpy(), ds["final"][lanes, g0 + p].numpy())
            _close(hidden[lanes, p], ds["hidden"][lanes, g0 + p].numpy(),
                   1e-5)


@pytest.mark.parametrize("fused", [False, True], ids=["logits", "fused"])
def test_sampled_collection_is_refused(fused):
    """Collection at the paper's augmentation ``temperatures=(0.0, 0.5)``,
    once refused, now runs, and equals the JAX collector's from one key:
    the key split once per temperature, the sampled trajectories drawn
    from the reference's stream. Tokens and step indices exactly, the
    hidden buffer within 1e-4."""
    jcfg, cfg = _configs()
    tree = _np_params(jcfg)
    rng = np.random.default_rng(7)
    prompts = rng.integers(2, cfg.vocab_size - 1, (3, P))
    gt = rng.integers(2, cfg.vocab_size - 1, (3, G))
    jcdlm = JaxCDLM(block_size=B, gen_length=G, prompt_length=P,
                    temperatures=(0.0, 0.5))
    cdlm = CDLMConfig(block_size=B, gen_length=G, prompt_length=P,
                      temperatures=(0.0, 0.5))
    key = jax.random.PRNGKey(11)
    want = jtraj.collect(_jax(tree), jnp.asarray(prompts), jnp.asarray(gt),
                         cfg=jcfg, cdlm=jcdlm, key=key)
    got = traj.collect(params_from_jax(tree, cfg, "cpu"), _t(prompts),
                       _t(gt), cfg=cfg, cdlm=cdlm,
                       key=_t(np.asarray(key)), fused_select=fused)
    for k in ("prompt", "gt", "final", "finalized_at"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    # the sampled half differs from the greedy half
    assert not np.array_equal(got["final"][:3].numpy(),
                              got["final"][3:].numpy())
    _close(got["hidden"], want["hidden"], 1e-4)


# ---------------------------------------------------------------------------
# training loops and CLI
# ---------------------------------------------------------------------------
def test_data_copies_give_the_jax_batches():
    from repro.data import Corpus as JaxCorpus
    from repro.data import TaskSpec as JaxTask
    from repro.data import answer_mask as jax_answer_mask
    for task in ("sort", "add"):
        kw = dict(vocab_size=512, prompt_len=15, gen_len=10, sort_k=8,
                  sort_range=24, add_digits=4)
        mine, theirs = Corpus(TaskSpec(task, **kw), 64, seed=3), \
            JaxCorpus(JaxTask(task, **kw), 64, seed=3)
        for a, b in zip(mine.batches(8, seed=1, epochs=2),
                        theirs.batches(8, seed=1, epochs=2)):
            for k in ("prompt", "answer"):
                np.testing.assert_array_equal(a[k], b[k])
            from repro_torch.data import answer_mask
            np.testing.assert_array_equal(answer_mask(a["answer"]),
                                          jax_answer_mask(b["answer"]))


def test_trainer_runs_teacher_collection_and_lora_student_on_cpu():
    jcfg, cfg = _configs()
    task = TaskSpec("sort", vocab_size=cfg.vocab_size, prompt_len=P,
                    gen_len=G, sort_k=4, sort_range=24)
    corpus = Corpus(task, 32, seed=0)
    tcfg = TrainConfig(learning_rate=1e-3, steps=2, batch_size=4,
                       remat=True)
    hist = []
    teacher = trainer.train_teacher(cfg, corpus, tcfg, device="cpu",
                                    verbose=False, history=hist)
    assert len(hist) == 2 and all(np.isfinite(float(h["loss"]))
                                  for h in hist)
    cdlm = CDLMConfig(block_size=B, gen_length=G, prompt_length=P,
                      temperatures=(0.0,))
    ds = trainer.collect_dataset(teacher, cfg, cdlm, corpus, n_examples=8,
                                 batch=4, verbose=False)
    assert ds["final"].shape == (8, G) and ds["hidden"].shape == \
        (8, G, cfg.d_model)
    assert sorted(ds["finalized_at"][0].tolist()) == list(range(G))
    hist = []
    student = trainer.train_student(
        teacher, ds, cfg, cdlm, dataclasses.replace(tcfg, use_lora=True,
                                                    lora_rank=4),
        efficient_loss=True, verbose=False, history=hist)
    assert set(hist[0]) == {"distill", "cons", "dlm", "aux", "grad_norm",
                            "lr", "loss"}
    assert all(np.isfinite(float(v)) for h in hist for v in h.values())
    assert set(student) == set(teacher)


@pytest.mark.parametrize("argv", [
    ["--stage", "teacher"], ["--stage", "ar"], ["--stage", "cdlm"],
    ["--stage", "cdlm", "--lora", "--task", "add"]],
    ids=["teacher", "ar", "cdlm", "cdlm-lora"])
def test_train_cli_on_cpu(argv, tmp_path, capsys):
    from repro_torch.launch import train
    ckpt = str(tmp_path / "out.npz")
    train.main(argv + ["--device", "cpu", "--steps", "2", "--student-steps",
                       "2", "--batch-size", "8", "--ckpt", ckpt])
    assert f"saved -> {ckpt}" in capsys.readouterr().out
    jcfg, _ = _configs()
    back = jckpt.restore(init_model(jax.random.PRNGKey(0), jcfg), ckpt)
    assert all(np.isfinite(np.asarray(x)).all()
               for x in jax.tree_util.tree_leaves(back))


def test_entry_points_need_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    jcfg, cfg = _configs()
    corpus = Corpus(TaskSpec("sort", vocab_size=512, prompt_len=P,
                             gen_len=G, sort_k=4, sort_range=24), 8)
    tcfg = TrainConfig(steps=1, batch_size=4)
    for call in (lambda: trainer.train_teacher(cfg, corpus, tcfg),
                 lambda: trainer.train_ar(cfg, corpus, tcfg)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--stage", "teacher", "--steps", "1"])


# ---------------------------------------------------------------------------
# the attention and select kernels have no backward: refused under autograd
# ---------------------------------------------------------------------------
def _kernel_calls():
    rng = np.random.default_rng(6)
    f = lambda *s: _t(rng.normal(0, 1, s).astype(np.float32))  # noqa: E731
    q, kb, vb = f(2, 4, 2, 3, 64), f(2, 4, 2, 64), f(2, 4, 2, 64)
    kc, vc = f(2, 8, 2, 64), f(2, 8, 2, 64)
    lens = torch.tensor([3, 8], dtype=torch.int32)
    table = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    kp, vp = kc.reshape(4, 4, 2, 64), vc.reshape(4, 4, 2, 64)
    h, w = f(5, 64), f(50, 64)
    return {
        "decode_attention": (lambda: decode_attention(q, kc, vc, kb, vb,
                                                      lens), q),
        "paged_decode_attention": (lambda: paged_decode_attention(
            q, kp, vp, kb, vb, table, lens), kp),
        "flash_block_attention": (lambda: flash_block_attention(
            q, kb, vb, mode="bidirectional"), vb),
        "fused_select": (lambda: fused_select(h, w, torch.ones(5, dtype=bool)),
                         h),
    }


@pytest.mark.parametrize("name", ["decode_attention",
                                  "paged_decode_attention",
                                  "flash_block_attention", "fused_select"])
def test_kernel_wrappers_refuse_inputs_that_require_grad(name):
    call, x = _kernel_calls()[name]
    call()                                  # plain inputs: runs
    x.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        call()
    with torch.no_grad():                   # the collector's way: runs
        call()


def test_training_forward_cannot_route_through_the_prefill_kernel():
    """Passing the block attention kernel to a forward whose params require
    grad raises instead of silently dropping the q/k/v gradients."""
    jcfg, cfg = _configs()
    params = params_from_jax(_np_params(jcfg), cfg, "cpu")
    tokens = torch.zeros((1, P + G), dtype=torch.int64)
    with pytest.raises(RuntimeError, match="no backward"):
        S.value_and_grad(lambda p: (forward(
            p, tokens, cfg=cfg, device="cpu",
            prefill_attention_fn=flash_block_attention).hidden.sum(), {}),
            params)
