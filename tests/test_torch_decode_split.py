"""The bf16 decode-attention kernel's split of the keys, modelled in plain
torch (``kernels/decode_attn/ref.py::decode_attention_split``): 64-key
tiles, a fixed number of tiles per split, partials per split merged in
order. The model against the plain version (1e-6 in fp32: the same sums
in another grouping) and against the JAX kernel run in interpret mode, as
``test_torch_kernels.py`` runs it (1e-4); its paged form against its dense
form bit for bit; and the probabilities as a bf16 pair at the serving
shapes, inside the kernel's 1e-4 limit where one rounding is not."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attn import decode_attention as jax_decode  # noqa: E402,E501
from repro_torch.kernels.decode_attn import ref as dref  # noqa: E402

torch.set_num_threads(2)


def _inputs(b, Bq, Kv, G, hd, S, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(0, 1, s).astype(np.float32)  # noqa: E731
    return (f(b, Bq, Kv, G, hd), f(b, S, Kv, hd), f(b, S, Kv, hd),
            f(b, Bq, Kv, hd), f(b, Bq, Kv, hd))


def _edge_lens(Kv, Bq, G):
    """S (not a multiple of 64) and lengths 0, on the first split edge, one
    past it, and S."""
    edge = dref.tiles_per_split(Kv, Bq * G) * dref.KEY_TILE
    S = edge + 40
    return S, [0, edge, edge + 1, S]


def test_split_plan_at_the_serving_shapes():
    """Tiles per split come from (Kv, rows) only; the grid's splits cover
    the most tiles any lane of an S-row cache can have."""
    for (Kv, G, hd), want in (((2, 7, 64), 2), ((4, 7, 128), 8),
                              ((32, 1, 128), 8)):
        assert dref.tiles_per_split(Kv, 32 * G) == want
        for S in (1, 64, 65, 768, 1000):
            T, n = dref.split_plan(Kv, 32, G, S)
            assert T == want
            tiles = -(-S // 64) + 1
            assert (n - 1) * T < tiles <= n * T


SPLIT_CASES = [
    # (G, hd, window, softcap)
    (7, 64, None, None),
    (1, 64, None, None),
    (7, 128, None, 5.0),
    (1, 128, 20, None),
    (7, 64, 70, 5.0),
]


@pytest.mark.parametrize("G,hd,window,softcap", SPLIT_CASES)
def test_split_model_matches_plain_and_jax(G, hd, window, softcap):
    b, Bq, Kv = 4, 32, 2
    S, lens = _edge_lens(Kv, Bq, G)
    q, kc, vc, kb, vb = _inputs(b, Bq, Kv, G, hd, S, seed=G + hd)
    kw = dict(scale=hd ** -0.5, softcap=softcap, window=window)
    t = [torch.as_tensor(a) for a in (q, kc, vc, kb, vb)]
    cl = torch.tensor(lens, dtype=torch.int32)
    got = dref.decode_attention_split(*t, cl, **kw)
    assert got.shape == q.shape and got.dtype == torch.float32
    want = dref.decode_attention(*t, cl, **kw)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    for i, n in enumerate(lens):
        lane = [jnp.asarray(a[i:i + 1]) for a in (q, kc, vc, kb, vb)]
        jax_out = jax_decode(*lane, n, interpret=True, **kw)
        np.testing.assert_allclose(got[i:i + 1].numpy(), np.asarray(jax_out),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("Kv,G,hd", [(4, 7, 128), (32, 1, 128)])
def test_longer_splits_match_plain(Kv, G, hd):
    """dream-7b's and llada-8b's head layouts (8 tiles a split), b=2,
    with lengths on and past their split edges."""
    b, Bq = 2, 32
    S, lens = _edge_lens(Kv, Bq, G)
    for lane_lens in (lens[:2], lens[2:]):
        t = [torch.as_tensor(a)
             for a in _inputs(b, Bq, Kv, G, hd, S, seed=Kv + G)]
        cl = torch.tensor(lane_lens, dtype=torch.int32)
        kw = dict(scale=hd ** -0.5)
        torch.testing.assert_close(dref.decode_attention_split(*t, cl, **kw),
                                   dref.decode_attention(*t, cl, **kw),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("page", [32, 16, 7, 5])
def test_paged_split_model_equals_dense_bitwise(page):
    """The same logical tiles and splits over a shuffled pool (residue in
    the unused pages, -1 past each lane's length): the paged model equals
    the dense one bit for bit, and the plain paged version to 1e-6."""
    b, Bq, Kv, G, hd = 4, 32, 2, 7, 64
    S0, lens = _edge_lens(Kv, Bq, G)
    n_t = -(-S0 // page)
    S = n_t * page
    q, kc, vc, kb, vb = (torch.as_tensor(a)
                         for a in _inputs(b, Bq, Kv, G, hd, S, seed=page))
    rng = np.random.default_rng(page)
    n_pages = 3 * b * n_t
    perm = torch.as_tensor(rng.permutation(n_pages)[:b * n_t])
    kp = torch.as_tensor(rng.normal(0, 1, (n_pages, page, Kv, hd)),
                         dtype=torch.float32)
    vp = torch.as_tensor(rng.normal(0, 1, (n_pages, page, Kv, hd)),
                         dtype=torch.float32)
    kp[perm] = kc.reshape(b * n_t, page, Kv, hd)
    vp[perm] = vc.reshape(b * n_t, page, Kv, hd)
    table = perm.to(torch.int32).reshape(b, n_t).clone()
    cl = torch.tensor(lens, dtype=torch.int32)
    table[torch.arange(n_t)[None, :] * page >= cl[:, None]] = -1
    kw = dict(scale=hd ** -0.5, softcap=5.0, window=90)
    dense = dref.decode_attention_split(q, kc, vc, kb, vb, cl, **kw)
    paged = dref.decode_attention_split(q, kp, vp, kb, vb, cl,
                                        page_table=table, **kw)
    assert torch.equal(paged, dense)
    torch.testing.assert_close(
        paged, dref.paged_decode_attention(q, kp, vp, kb, vb, table, cl,
                                           **kw), rtol=1e-6, atol=1e-6)


# the serving shapes: 8 lanes of a 32-token block against a 768-row cache
LENS8 = [0, 512, 536, 577, 608, 640, 700, 736]


@pytest.mark.parametrize("name,Kv,G,hd", [("qwen2-0.5b", 2, 7, 64),
                                          ("dream-7b", 4, 7, 128),
                                          ("llada-8b", 32, 1, 128)])
def test_probabilities_as_a_bf16_pair_hold_the_kernel_limit(name, Kv, G, hd):
    """Why the bf16 kernel's PV product takes P as a pair, at the decode
    shapes: with p_hi = bf16(p) and p_lo = bf16(p - p_hi), each split's
    (p_hi + p_lo) v lies within 2^-18 |p| max|v|, so the merged output
    within 2^-18 max|v| (plus fp32 rounding, 1e-6) of the fp32 split, a
    third of the kernel's 1e-4 limit at most; one bf16 rounding of p lies
    outside that limit."""
    b, Bq, S = 8, 32, 768
    q, kc, vc, kb, vb = (torch.as_tensor(a).bfloat16().float()
                         for a in _inputs(b, Bq, Kv, G, hd, S, seed=hd + G))
    cl = torch.tensor(LENS8, dtype=torch.int32)
    kw = dict(scale=hd ** -0.5)
    want = dref.decode_attention_split(q, kc, vc, kb, vb, cl, **kw)
    pair = dref.decode_attention_split(q, kc, vc, kb, vb, cl,
                                       p_round="pair", **kw)
    once = dref.decode_attention_split(q, kc, vc, kb, vb, cl,
                                       p_round="bf16", **kw)
    bound = 2 ** -18 * max(vc.abs().max().item(), vb.abs().max().item()) \
        + 1e-6
    assert bound < 1e-4 / 3
    assert (pair - want).abs().max().item() <= bound
    assert (once - want).abs().max().item() > 1e-4
