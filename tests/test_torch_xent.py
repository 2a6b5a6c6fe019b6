"""The port's fused cross-entropy against the JAX package's: the plain
forward (``ref.xent_streaming``, what ``fused_xent`` runs on the CPU)
against the JAX ``fused_xent`` (Pallas in interpret mode) and the oracle
``xent_ref``, at vocab sizes no power of two divides; the autograd route's
dh and dW against ``jax.grad`` of the JAX ``fused_xent`` with a
non-uniform upstream gradient that has zeros; a tied embedding, whose
gradient sums the lookup's and the head's. fp32 within 1e-5 (both sides
sum fp32 products in other orders), bf16 within 2e-2 (the stated limit for
bf16 inputs), gradients within 1e-5 of max|grad|."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.xent import fused_xent as jax_fused_xent  # noqa: E402
from repro.kernels.xent import xent_ref as jax_xent_ref  # noqa: E402
from repro_torch.kernels.xent import fused_xent  # noqa: E402
from repro_torch.kernels.xent import ref  # noqa: E402

torch.set_num_threads(2)

SHAPES = [(128, 64, 512), (200, 32, 1000), (64, 128, 593)]


def _inputs(T, d, V, seed=0):
    rng = np.random.default_rng(seed)
    h = rng.normal(0, 1, (T, d)).astype(np.float32)
    w = rng.normal(0, 0.3, (V, d)).astype(np.float32)      # port (V, d)
    y = rng.integers(0, V, (T,)).astype(np.int32)
    y[:3] = [0, V - 1, V // 2]                             # both vocab edges
    g = rng.uniform(0.2, 2.0, (T,)).astype(np.float32)
    g[::7] = 0.0                                           # rows with g = 0
    return h, w, y, g


def _close(got, want, tol):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("T,d,V", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_forward_matches_jax(T, d, V, dtype):
    h, w, y, _ = _inputs(T, d, V)
    tol = 1e-5 if dtype == "float32" else 2e-2
    jh = jnp.asarray(h, dtype)
    jw = jnp.asarray(w.T, dtype)
    want_kernel = jax_fused_xent(jh, jw, jnp.asarray(y))
    want_oracle = jax_xent_ref(jh, jw, jnp.asarray(y))
    th = torch.tensor(h).to(getattr(torch, dtype))
    tw = torch.tensor(w).to(getattr(torch, dtype))
    got = fused_xent(th, tw, torch.tensor(y))
    assert got.dtype == torch.float32 and got.shape == (T,)
    _close(got, want_kernel, tol)
    _close(got, want_oracle, tol)
    _close(ref.xent_ref(th, tw, torch.tensor(y)), want_oracle, tol)
    # the streaming logz is the oracle's logsumexp
    _, logz = ref.xent_streaming(th, tw, torch.tensor(y), chunk=256)
    _close(logz, jax.nn.logsumexp(
        jnp.asarray(th.float().numpy()) @ jnp.asarray(tw.float().numpy()).T,
        axis=-1), 1e-5)


@pytest.mark.parametrize("T,d,V", SHAPES)
def test_autograd_grads_match_jax(T, d, V):
    h, w, y, g = _inputs(T, d, V, seed=1)
    jg = jnp.asarray(g)

    def jloss(hh, ww):
        return jnp.sum(jg * jax_fused_xent(hh, ww, jnp.asarray(y)))

    want_dh, want_dw = jax.grad(jloss, (0, 1))(jnp.asarray(h),
                                               jnp.asarray(w.T))
    th = torch.tensor(h, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    loss = (torch.tensor(g) * fused_xent(th, tw, torch.tensor(y))).sum()
    dh, dw = torch.autograd.grad(loss, (th, tw))
    assert dh.dtype == th.dtype and dw.dtype == tw.dtype
    _close(dh, want_dh, 1e-5 * float(jnp.abs(want_dh).max()))
    _close(dw.t(), want_dw, 1e-5 * float(jnp.abs(want_dw).max()))
    # rows with g = 0 still count: they get exactly zero dh
    assert torch.all(dh[::7] == 0)


def test_bf16_grads_come_back_in_the_input_dtype():
    h, w, y, g = _inputs(64, 32, 593, seed=2)
    th = torch.tensor(h).bfloat16().requires_grad_()
    tw = torch.tensor(w).bfloat16().requires_grad_()
    loss = (torch.tensor(g) * fused_xent(th, tw, torch.tensor(y))).sum()
    dh, dw = torch.autograd.grad(loss, (th, tw))
    assert dh.dtype == torch.bfloat16 and dw.dtype == torch.bfloat16

    def jloss(hh, ww):
        return jnp.sum(jnp.asarray(g) * jax_fused_xent(hh, ww,
                                                       jnp.asarray(y)))

    want_dh, want_dw = jax.grad(jloss, (0, 1))(
        jnp.asarray(h, jnp.bfloat16), jnp.asarray(w.T, jnp.bfloat16))
    # both round an fp32 sum to bf16: one bf16 ulp (2^-8 relative) apart
    for got, want in ((dh, want_dh), (dw.t(), want_dw)):
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got.float().numpy(), want,
                                   rtol=2 ** -7,
                                   atol=1e-5 * np.abs(want).max())


def test_tied_embedding_gradient_sums_lookup_and_head():
    """E (V, d) embeds the tokens and is the head: autograd adds the head's
    dW to the lookup's gradient, as ``jax.grad`` does through E.T."""
    T, d, V = 48, 32, 1000
    rng = np.random.default_rng(3)
    E = rng.normal(0, 0.3, (V, d)).astype(np.float32)
    A = rng.normal(0, 0.3, (d, d)).astype(np.float32)
    x = rng.integers(0, V, (T,))
    y = rng.integers(0, V, (T,)).astype(np.int32)
    g = rng.uniform(0.0, 1.0, (T,)).astype(np.float32)

    def jloss(e):
        hh = jnp.tanh(e[x] @ A)
        return jnp.sum(g * jax_fused_xent(hh, e.T, jnp.asarray(y)))

    want = jax.grad(jloss)(jnp.asarray(E))
    tE = torch.tensor(E, requires_grad=True)
    hh = torch.tanh(tE[torch.tensor(x)] @ torch.tensor(A))
    loss = (torch.tensor(g) * fused_xent(hh, tE, torch.tensor(y))).sum()
    (got,) = torch.autograd.grad(loss, (tE,))
    _close(got, want, 1e-5 * float(jnp.abs(want).max()))


def test_plain_backward_two_pass_equals_given_logz_and_oracle():
    h, w, y, g = _inputs(200, 32, 1000, seed=4)
    th, tw, ty, tg = (torch.tensor(a) for a in (h, w, y, g))
    dh2, dw2 = ref.xent_backward(th, tw, ty, tg, chunk=128)
    _, logz = ref.xent_streaming(th, tw, ty)
    dh1, dw1 = ref.xent_backward(th, tw, ty, tg, logz, chunk=300)
    dh0, dw0 = torch.autograd.grad(
        (tg * ref.xent_ref(th.requires_grad_(), tw.requires_grad_(),
                           ty)).sum(), (th, tw))
    for a, b in ((dh2, dh0), (dh1, dh0), (dw2, dw0), (dw1, dw0)):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-5 * float(b.abs().max()))
    dh3, dw3 = ref.xent_backward(th.detach(), tw.detach(), ty, tg,
                                 need_dw=False)
    assert dw3 is None
    torch.testing.assert_close(dh3, dh2, rtol=0,
                               atol=1e-5 * float(dh2.abs().max()))


def test_only_the_needed_gradients_are_returned():
    h, w, y, _ = _inputs(64, 32, 593, seed=5)
    th = torch.tensor(h, requires_grad=True)
    tw = torch.tensor(w)                      # frozen head (LoRA)
    loss = fused_xent(th, tw, torch.tensor(y)).sum()
    loss.backward()
    assert th.grad is not None and tw.grad is None


def test_no_launch_on_the_cpu_and_bad_calls_raise():
    h, w, y, g = _inputs(64, 32, 512, seed=6)
    before = (fused_xent.launches, fused_xent.backward_launches)
    th = torch.tensor(h, requires_grad=True)
    (torch.tensor(g) * fused_xent(th, torch.tensor(w),
                                  torch.tensor(y))).sum().backward()
    assert (fused_xent.launches, fused_xent.backward_launches) == before
    with pytest.raises(ValueError, match="softcap"):
        fused_xent(th, torch.tensor(w), torch.tensor(y), softcap=30.0)
    with pytest.raises(ValueError, match="do not match"):
        fused_xent(th, torch.tensor(w[:, :16]), torch.tensor(y))


@pytest.mark.parametrize("T,V,tile,per_sm", [
    (1024, 151_936, 64, 4), (128, 151_936, 64, 4), (300, 50_021, 64, 4),
    (1, 593, 64, 4), (5000, 1000, 32, 4), (1024, 151_936, 128, 1),
    (300, 50_021, 128, 1)])
def test_vocab_chunking_covers_the_vocabulary_once(T, V, tile, per_sm):
    """The vocab-chunked grid shared by the xent and select wrappers: every
    vocab tile falls in exactly one chunk, no chunk is empty, and the grid
    holds no more than about ``per_sm`` blocks per SM."""
    from repro_torch.kernels import _build
    per_chunk, n_chunks = _build.chunking(T, V, 132, tile, tile, per_sm)
    vocab_tiles = -(-V // tile)
    assert per_chunk >= 1
    assert (n_chunks - 1) * per_chunk < vocab_tiles <= n_chunks * per_chunk
    row_tiles = -(-T // tile)
    assert row_tiles * n_chunks <= max(per_sm * 132, row_tiles) + row_tiles


@pytest.mark.parametrize("T,V", [(1024, 151_936), (300, 50_021), (1, 593),
                                 (256, 9000), (16_384, 151_936),
                                 (100_000, 1000)])
def test_backward_chunks_cover_the_vocabulary_within_the_l2_budget(T, V):
    """The backward's vocab chunks: whole 128-row tiles that cover the
    vocabulary once, in order, with the ``4 T chunk``-byte scratch (fp32
    probabilities or the bf16 pair) within ``PROBS_BYTES`` unless one tile
    alone exceeds it; at the training shape 4,096 rows, 16 MB."""
    from repro_torch.kernels.xent import ops as xops
    chunk = xops.backward_chunk(T, V)
    assert chunk % xops.CHUNK_ALIGN == 0 and chunk > 0
    starts = list(range(0, V, chunk))
    widths = [min(chunk, V - v0) for v0 in starts]
    assert sum(widths) == V and all(w > 0 for w in widths)
    assert (4 * T * chunk <= xops.PROBS_BYTES
            or chunk == xops.CHUNK_ALIGN)
    assert chunk <= -(-V // 128) * 128
    if (T, V) == (1024, 151_936):
        assert chunk == 4096 and len(starts) == 38
        assert 4 * T * chunk == 16 << 20
