"""The port's kernels: each plain version against the JAX kernel, run as the
JAX suite runs it on the CPU (``interpret=True``), and against the JAX
oracles, on the same numpy inputs, and the wrappers' CPU route (the CUDA
kernels themselves are held against the plain versions by
``test_torch_cuda.py`` and ``chip_smoke.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attn import decode_attention as jax_decode  # noqa: E402,E501
from repro.kernels.decode_attn import decode_attention_ref  # noqa: E402
from repro.kernels.select import fused_select as jax_select  # noqa: E402
from repro.kernels.select import select_ref as jax_select_ref  # noqa: E402
from repro_torch.kernels.decode_attn import decode_attention  # noqa: E402
from repro_torch.kernels.decode_attn import ref as dref  # noqa: E402
from repro_torch.kernels.select import fused_select  # noqa: E402
from repro_torch.kernels.select import ref as sref  # noqa: E402

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------
def _attn_inputs(b=4, Bq=8, Kv=2, G=2, hd=64, S=64, lens=(0, 5, 16, 40),
                 seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(0, 1, s).astype(np.float32)  # noqa: E731
    return (f(b, Bq, Kv, G, hd), f(b, S, Kv, hd), f(b, S, Kv, hd),
            f(b, Bq, Kv, hd), f(b, Bq, Kv, hd), np.asarray(lens, np.int32))


ATTN_CASES = [
    # (G, window, softcap, dtype)
    (2, None, None, "float32"),
    (7, 6, None, "float32"),
    (2, None, 5.0, "float32"),
    (2, 6, 5.0, "bfloat16"),
]


@pytest.mark.parametrize("G,window,softcap,dtype", ATTN_CASES)
def test_decode_attention_plain_matches_jax(G, window, softcap, dtype):
    q, kc, vc, kb, vb, lens = _attn_inputs(G=G)
    tol = 1e-4 if dtype == "float32" else 2e-2
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    scale = 0.125
    kw = dict(scale=scale, softcap=softcap, window=window)
    t = [torch.as_tensor(a).to(tdt) for a in (q, kc, vc, kb, vb)]
    before = decode_attention.launches
    got = decode_attention(*t, torch.as_tensor(lens), **kw).numpy()
    assert decode_attention.launches == before   # CPU: no kernel launch
    assert got.shape == q.shape
    # the JAX op takes one scalar cache_len: loop over lanes
    for i, n in enumerate(lens):
        lane = [jnp.asarray(a[i:i + 1], jdt) for a in (q, kc, vc, kb, vb)]
        want = jax_decode(*lane, n, interpret=True, **kw)
        oracle = decode_attention_ref(*lane, n, **kw)
        np.testing.assert_allclose(got[i:i + 1], np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)
        np.testing.assert_allclose(got[i:i + 1],
                                   np.asarray(oracle, np.float32),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("Kv,G,hd,window,softcap", [
    (4, 1, 256, None, None),       # gemma-7b's G and head_dim
    (4, 1, 256, 20, 50.0),         # gemma2's softcap, a window scaled down
    (2, 8, 112, None, None),       # kimi-k2's G and head_dim
    (2, 8, 112, 20, 50.0),
])
def test_decode_attention_plain_matches_jax_at_new_head_dims(Kv, G, hd,
                                                             window, softcap):
    """The plain version at the head dims the kernels gained, against the
    JAX kernel (interpret mode) and oracle, fp32 at 1e-4."""
    q, kc, vc, kb, vb, lens = _attn_inputs(Kv=Kv, G=G, hd=hd, seed=hd)
    kw = dict(scale=hd ** -0.5, softcap=softcap, window=window)
    got = decode_attention(*(torch.as_tensor(a) for a in (q, kc, vc, kb, vb)),
                           torch.as_tensor(lens), **kw).numpy()
    for i, n in enumerate(lens):
        lane = [jnp.asarray(a[i:i + 1]) for a in (q, kc, vc, kb, vb)]
        for want in (jax_decode(*lane, n, interpret=True, **kw),
                     decode_attention_ref(*lane, n, **kw)):
            np.testing.assert_allclose(got[i:i + 1], np.asarray(want),
                                       rtol=1e-4, atol=1e-4)


def test_decode_attention_reads_strided_cache():
    """A period slice of the stacked cache (non-contiguous over lanes) gives
    the same result as a contiguous copy."""
    q, kc, vc, kb, vb, lens = _attn_inputs()
    stacked = torch.as_tensor(np.stack([kc, kc])), \
        torch.as_tensor(np.stack([vc, vc]))
    t = [torch.as_tensor(a) for a in (q, kb, vb)]
    got = decode_attention(t[0], stacked[0][1], stacked[1][1], t[1], t[2],
                           torch.as_tensor(lens), scale=0.125)
    want = dref.decode_attention(t[0], torch.as_tensor(kc),
                                 torch.as_tensor(vc), t[1], t[2],
                                 torch.as_tensor(lens), scale=0.125)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# fused select
# ---------------------------------------------------------------------------
def _select_inputs(T, d, V, seed=0, scale=0.5):
    rng = np.random.default_rng(seed)
    h = (rng.normal(0, 1, (T, d)) * scale).astype(np.float32)
    w = (rng.normal(0, 1, (V, d)) * 0.1).astype(np.float32)   # (V, d) rows
    masked = rng.random(T) < 0.7
    return h, w, masked


def _check_select(got, want, tol=1e-4):
    gc, gf = (np.asarray(x) for x in got)
    wc, wf = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(gc, wc)
    np.testing.assert_array_equal(np.isneginf(gf), np.isneginf(wf))
    fin = np.isfinite(wf)
    np.testing.assert_allclose(gf[fin], wf[fin], rtol=tol, atol=0)


@pytest.mark.parametrize("T,d,V,softcap", [
    (64, 32, 512, None),       # vocab divisible by the JAX tile
    (64, 32, 593, None),       # vocab not divisible by any tile
    (40, 48, 1000, 30.0),      # ragged rows + softcap
    (8, 16, 100, None),        # vocab smaller than one tile
])
def test_select_plain_matches_jax(T, d, V, softcap):
    h, w, masked = _select_inputs(T, d, V, seed=T + V)
    jh, jw, jm = jnp.asarray(h), jnp.asarray(w.T), jnp.asarray(masked)
    want = jax_select(jh, jw, jm, softcap=softcap, impl="pallas",
                      interpret=True)
    oracle = jax_select_ref(jh, jw, jm, softcap=softcap)
    th, tw, tm = torch.as_tensor(h), torch.as_tensor(w), torch.as_tensor(
        masked)
    before = fused_select.launches
    wrapped = fused_select(th, tw, tm, softcap=softcap)
    assert fused_select.launches == before      # CPU: no kernel launch
    chunked = sref.select_streaming(th, tw, tm, softcap=softcap, chunk=64)
    dense = sref.select_ref(th, tw, tm, softcap=softcap)
    for got in (wrapped, chunked, dense):
        _check_select(got, want)
        _check_select(got, oracle)


def test_select_bf16_matches_jax():
    h, w, masked = _select_inputs(96, 64, 700, seed=7)
    jh = jnp.asarray(h, jnp.bfloat16)
    jw = jnp.asarray(w.T, jnp.bfloat16)
    want = jax_select(jh, jw, jnp.asarray(masked), impl="pallas",
                      interpret=True)
    got = fused_select(torch.as_tensor(h).bfloat16(),
                       torch.as_tensor(w).bfloat16(), torch.as_tensor(masked))
    # fp32 accumulation over identical bf16 inputs: candidates exact
    _check_select(got, want, tol=2e-2)


def test_select_ties_and_finalized_rows():
    """All-equal rows pick column 0; a maximum planted in two vocab chunks
    resolves to the lower index; finalized rows get -inf."""
    T, d, V = 16, 8, 700
    h, w, masked = _select_inputs(T, d, V, seed=3)
    w[[130, 600]] = 5.0 * np.sign(h.sum(0))           # cross-chunk tie
    h = np.abs(h) * np.sign(h.sum(0))
    masked[:4] = False
    th, tw, tm = (torch.as_tensor(a) for a in (h, w, masked))
    jw = jnp.asarray(w.T)
    want = jax_select(jnp.asarray(h), jw, jnp.asarray(masked),
                      impl="pallas", interpret=True)
    for chunk in (64, 128, 4096):
        got = sref.select_streaming(th, tw, tm, chunk=chunk)
        _check_select(got, want)
        assert np.all(got[0].numpy() == 130)
        assert np.all(np.isneginf(got[1].numpy()[:4]))
    zeros = sref.select_streaming(torch.zeros((4, d)), tw,
                                  torch.ones(4, dtype=torch.bool), chunk=64)
    assert np.all(zeros[0].numpy() == 0)


@pytest.mark.parametrize("T", [32, 128, 256])
@pytest.mark.parametrize("V", [151_936, 152_064, 50_021])
def test_tensor_core_chunking_covers_every_vocab_tile_once(T, V):
    """The bf16 select's (and the xent forward's) vocab split on a 132-SM
    card, 128-row and 128-vocab-row tiles, one block per SM: the chunks of
    per_chunk tiles cover every vocab tile exactly once, none is empty, and
    the grid is about one wave."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.select import ops as sops
    n_sms = 132
    row_tile, vocab_tile, per_sm = sops.TILES[torch.bfloat16]
    assert (row_tile, vocab_tile, per_sm) == (128, 128, 1)
    per_chunk, n_chunks = _build.chunking(T, V, n_sms, row_tile, vocab_tile,
                                          per_sm)
    tiles = -(-V // vocab_tile)
    covered = [t for c in range(n_chunks)
               for t in range(c * per_chunk, min((c + 1) * per_chunk, tiles))]
    assert covered == list(range(tiles))
    assert all(c * per_chunk < tiles for c in range(n_chunks))
    assert -(-T // row_tile) * n_chunks <= n_sms
