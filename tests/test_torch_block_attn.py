"""The port's block attention (the prefill kernel's plain version) against
the JAX Pallas kernel, run as the JAX suite runs it on the CPU
(``interpret=True``), and against the JAX oracle, on the same numpy inputs:
the three visibility modes, with window, softcap, GQA and a ragged L. Then
the model's prefill hook: a cache-less forward through the kernel's
wrapper against the generic forward and the JAX forward.

Tolerance 1e-4 absolute and relative, in fp32. In bf16 the two prefills
would differ by more than rounding order: the model's generic attention
(and the JAX serving prefill) casts the probabilities to bf16 before the PV
product, the kernel and its plain version keep them in fp32."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.block_attn import block_attention_ref  # noqa: E402
from repro.kernels.block_attn import (  # noqa: E402
    flash_block_attention as jax_flash,
)
from repro_torch.kernels.block_attn import flash_block_attention  # noqa: E402
from repro_torch.kernels.block_attn import ref as bref  # noqa: E402

torch.set_num_threads(2)
TOL = 1e-4


def _oracle(q, k, v, **kw):
    """The JAX oracle, which takes heads pre-broadcast (b, Kv*G, L, hd)."""
    b, L, Kv, G, hd = q.shape
    qh = q.transpose(0, 2, 3, 1, 4).reshape(b, Kv * G, L, hd)
    kh, vh = (np.repeat(a.transpose(0, 2, 1, 3), G, axis=1) for a in (k, v))
    out = block_attention_ref(jnp.asarray(qh), jnp.asarray(kh),
                              jnp.asarray(vh), **kw)
    return np.asarray(out).reshape(b, Kv, G, L, hd).transpose(0, 3, 1, 2, 4)


def _inputs(b, L, Kv, G, hd, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(0, 1, s).astype(np.float32)  # noqa: E731
    return f(b, L, Kv, G, hd), f(b, L, Kv, hd), f(b, L, Kv, hd)


CASES = [
    # (mode, L, G, prompt_len, block_size, window, softcap)
    ("block_causal", 32, 2, 8, 4, None, None),
    ("block_causal", 36, 3, 12, 8, None, 5.0),       # ragged L, P < L
    ("block_causal", 24, 1, 24, 4, None, None),      # prefill: all prompt
    ("block_causal", 40, 2, 8, 8, 9, None),          # window
    ("causal", 33, 2, 0, 1, None, None),
    ("causal", 48, 4, 0, 1, 7, 3.0),                 # window + softcap
    ("bidirectional", 29, 2, 0, 1, None, None),      # ragged L
    ("bidirectional", 32, 3, 0, 1, 5, None),
]


@pytest.mark.parametrize("mode,L,G,prompt_len,block_size,window,softcap",
                         CASES)
def test_block_attention_plain_matches_jax(mode, L, G, prompt_len,
                                           block_size, window, softcap):
    b, Kv, hd = 2, 2, 32
    q, k, v = _inputs(b, L, Kv, G, hd, seed=L + G)
    kw = dict(mode=mode, prompt_len=prompt_len, block_size=block_size,
              window=window, scale=hd ** -0.5, softcap=softcap)
    before = flash_block_attention.launches
    got = flash_block_attention(torch.as_tensor(q), torch.as_tensor(k),
                                torch.as_tensor(v), **kw)
    assert flash_block_attention.launches == before   # CPU: no kernel
    assert got.dtype == torch.float32 and got.shape == q.shape
    got = got.numpy()
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     block_q=16, block_k=16, interpret=True, **kw)
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, _oracle(q, k, v, **kw), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("Kv,G,hd,mode,window,softcap", [
    (2, 1, 256, "block_causal", None, None),   # gemma-7b's G and head_dim
    (2, 2, 128, "bidirectional", 9, 50.0),     # gemma2's local slot, scaled
    (2, 8, 112, "causal", None, None),         # kimi-k2's G and head_dim
    (1, 8, 112, "block_causal", 9, 50.0),
    (1, 1, 256, "bidirectional", 9, 50.0),
])
def test_block_attention_plain_matches_jax_at_new_head_dims(Kv, G, hd, mode,
                                                            window, softcap):
    """The plain version at the head dims the kernels gained, against the
    JAX kernel (interpret mode) and oracle, fp32 at 1e-4."""
    L, P, bs = 36, 12, 8
    q, k, v = _inputs(2, L, Kv, G, hd, seed=hd + G)
    kw = dict(mode=mode, prompt_len=P, block_size=bs, window=window,
              scale=hd ** -0.5, softcap=softcap)
    got = flash_block_attention(torch.as_tensor(q), torch.as_tensor(k),
                                torch.as_tensor(v), **kw).numpy()
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     block_q=16, block_k=16, interpret=True, **kw)
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, _oracle(q, k, v, **kw), rtol=TOL,
                               atol=TOL)


def test_block_attention_ragged_last_block_matches_oracle():
    """L ends inside a CDLM block. The JAX wrapper pads L to its tile with
    zero keys, and under block_causal the padded positions of that last
    block are visible to its real rows, so the JAX kernel's last rows are
    off there; the port masks the ragged edge in the kernel instead, and is
    held against the oracle."""
    b, L, Kv, G, hd = 2, 37, 2, 3, 32
    q, k, v = _inputs(b, L, Kv, G, hd, seed=3)
    kw = dict(mode="block_causal", prompt_len=12, block_size=8, window=None,
              scale=hd ** -0.5, softcap=5.0)
    got = flash_block_attention(torch.as_tensor(q), torch.as_tensor(k),
                                torch.as_tensor(v), **kw).numpy()
    np.testing.assert_allclose(got, _oracle(q, k, v, **kw), rtol=TOL,
                               atol=TOL)
    jax_out = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), block_q=16, block_k=16,
                                   interpret=True, **kw))
    bad = ~np.isclose(got, jax_out, rtol=TOL, atol=TOL).all(axis=(0, 2, 3, 4))
    assert np.flatnonzero(bad).tolist() == [36]


def test_visibility_matches_the_jax_oracle():
    from repro.kernels.block_attn.ref import visibility as jax_visibility
    for mode in bref.MODES:
        for window in (None, 3):
            kw = dict(mode=mode, prompt_len=5, block_size=3, window=window)
            np.testing.assert_array_equal(
                bref.visibility(13, 13, **kw).numpy(),
                np.asarray(jax_visibility(13, 13, **kw)))
    with pytest.raises(ValueError, match="mode"):
        bref.visibility(4, 4, mode="bogus", prompt_len=0, block_size=1,
                        window=None)


@pytest.mark.parametrize("mode", ["block_causal", "causal", "bidirectional"])
def test_prefill_hook_matches_generic_and_jax_forward(mode):
    """A cache-less forward through ``prefill_attention_fn`` equals the
    generic attention's forward and the JAX forward at fp32; with explicit
    positions the hook is not taken (the kernel derives visibility from
    indices)."""
    import jax

    from repro.configs.registry import get_config as jax_get_config
    from repro.models import forward as jax_forward
    from repro.models import init_model
    from repro_torch.bridge import params_from_jax
    from repro_torch.configs import get_config
    from repro_torch.models import forward

    jcfg = jax_get_config("qwen2-0.5b").reduced(dtype="float32")
    cfg = get_config("qwen2-0.5b").reduced(dtype="float32")
    tree = jax.tree_util.tree_map(np.asarray,
                                  init_model(jax.random.PRNGKey(0), jcfg))
    params = params_from_jax(tree, cfg, "cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 24))
    kw = dict(mode=mode, prompt_len=8, block_size=4)
    calls = []

    def hook(*args, **kwargs):
        calls.append(kwargs["mode"])
        return flash_block_attention(*args, **kwargs)

    got = forward(params, torch.as_tensor(tokens), cfg=cfg, device="cpu",
                  prefill_attention_fn=hook, **kw)
    assert calls == [mode] * cfg.n_layers
    generic = forward(params, torch.as_tensor(tokens), cfg=cfg, device="cpu",
                      **kw)
    want = jax_forward(jax.tree_util.tree_map(jnp.asarray, tree),
                       jnp.asarray(tokens), cfg=jcfg, **kw)
    for ref_out in (generic.logits.numpy(), np.asarray(want.logits)):
        np.testing.assert_allclose(got.logits.numpy(), ref_out, rtol=TOL,
                                   atol=TOL)
    forward(params, torch.as_tensor(tokens), cfg=cfg, device="cpu",
            positions=torch.arange(24), prefill_attention_fn=hook, **kw)
    assert len(calls) == cfg.n_layers


# the shapes of test_torch_cuda.py's bf16 (tensor-core) block attention
# cases, b = 2: (mode, L, G, hd, prompt_len, block_size, window, softcap)
TC_SHAPES = [
    ("block_causal", 100, 7, 64, 40, 16, None, None),
    ("causal", 96, 7, 128, 0, 1, None, None),
    ("block_causal", 130, 7, 64, 50, 16, 20, None),
    ("bidirectional", 70, 7, 128, 0, 1, None, 5.0),
    ("causal", 77, 4, 128, 0, 1, 9, 3.0),
    ("block_causal", 512, 7, 64, 512, 32, None, None),
    ("bidirectional", 384, 7, 64, 128, 32, None, None),
]

@pytest.mark.parametrize("mode,L,G,hd,prompt_len,block_size,window,softcap",
                         TC_SHAPES)
def test_probabilities_as_a_bf16_pair_hold_the_kernel_limit(
        mode, L, G, hd, prompt_len, block_size, window, softcap):
    """Why the bf16 route's PV product takes P as a pair: a model of it in
    plain torch. With p_hi = bf16(p) and p_lo = bf16(p - p_hi), what is
    left of p is at most half a bf16 ulp of p_lo, 2^-18 p, so (p_hi + p_lo)
    v lies within 2^-18 max|v| (plus fp32 rounding, 1e-6) of the fp32
    output, under 2e-5 at the shapes the CUDA tests hold to 1e-4; one bf16
    rounding of p (2^-9 p) lies outside 1e-4 there."""
    b, Kv = 2, 2
    q, k, v = (torch.as_tensor(a).bfloat16().float()
               for a in _inputs(b, L, Kv, G, hd, seed=L + G + hd))
    kw = dict(mode=mode, prompt_len=prompt_len, block_size=block_size,
              window=window, scale=hd ** -0.5, softcap=softcap)
    want = bref.block_attention(q, k, v, **kw)
    s = torch.einsum("bqkgh,bskh->bkgqs", q, k) * kw["scale"]
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    vis = bref.visibility(L, L, mode=mode, prompt_len=prompt_len,
                          block_size=block_size, window=window)
    p = torch.softmax(torch.where(vis, s, torch.full_like(s, bref.NEG_INF)),
                      -1)
    p_hi = p.bfloat16().float()
    p_lo = (p - p_hi).bfloat16().float()

    def pv(pp):
        return torch.einsum("bkgqs,bskh->bqkgh", pp, v)

    bound = 2 ** -18 * v.abs().max().item() + 1e-6
    assert bound < 2e-5
    assert (pv(p_hi + p_lo) - want).abs().max().item() <= bound
    assert (pv(p_hi) - want).abs().max().item() > 1e-4
