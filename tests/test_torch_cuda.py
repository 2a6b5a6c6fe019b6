"""The port's CUDA kernels against their plain PyTorch versions, on a CUDA
device (skipped elsewhere: a CUDA kernel has no CPU mode). Imports nothing
of JAX, so it runs on a machine without it:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.block_attn import flash_block_attention  # noqa: E402
from repro_torch.kernels.block_attn import ref as bref  # noqa: E402
from repro_torch.kernels.decode_attn import (  # noqa: E402
    decode_attention,
    paged_decode_attention,
)
from repro_torch.kernels.decode_attn import ref as dref  # noqa: E402
from repro_torch.kernels.select import fused_select  # noqa: E402
from repro_torch.kernels.select import ref as sref  # noqa: E402
from repro_torch.kernels.xent import fused_xent  # noqa: E402
from repro_torch.kernels.xent import ops as xops  # noqa: E402
from repro_torch.kernels.xent import ref as xref  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(gen, *shape):
    return torch.randn(shape, generator=gen, device=gen.device)


@pytest.mark.cuda
@pytest.mark.parametrize("G,hd,window,softcap,dtype", [
    (2, 64, None, None, torch.float32),
    (7, 64, 6, None, torch.float32),
    (2, 128, None, 5.0, torch.float32),
    (7, 128, 6, 5.0, torch.bfloat16),
    (7, 64, None, None, torch.bfloat16),
    (1, 128, None, None, torch.bfloat16),   # llada-8b's G and head_dim
    (1, 128, 6, 5.0, torch.float32),
])
def test_decode_attention_kernel_matches_plain(cuda, G, hd, window, softcap,
                                               dtype):
    gen = torch.Generator(device=cuda).manual_seed(G + hd)
    b, Bq, Kv, S = 4, 8, 2, 80
    q = _randn(gen, b, Bq, Kv, G, hd).to(dtype)
    kc, vc = (_randn(gen, 2, b, S, Kv, hd)[1].to(dtype) for _ in range(2))
    kb, vb = (_randn(gen, b, Bq, Kv, hd).to(dtype) for _ in range(2))
    lens = torch.tensor([0, 5, 33, 80], dtype=torch.int32, device=cuda)
    kw = dict(scale=hd ** -0.5, softcap=softcap, window=window)
    before = decode_attention.launches
    got = decode_attention(q, kc, vc, kb, vb, lens, **kw)
    assert decode_attention.launches == before + 1
    want = dref.decode_attention(q, kc, vc, kb, vb, lens, **kw)
    # both sides read the same inputs and accumulate in fp32
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("Kv,G,hd", [(2, 7, 64), (4, 7, 128), (8, 4, 128)],
                         ids=["qwen2-0.5b", "dream-7b", "jamba"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_at_one_query_row_matches_plain(cuda, Kv, G, hd,
                                                         dtype):
    """The AR step: one query row per lane (G folded rows of a 64-row
    tile), caches of 576 rows filled to 512..575."""
    gen = torch.Generator(device=cuda).manual_seed(Kv + hd)
    b, Bq, S = 8, 1, 576
    q = _randn(gen, b, Bq, Kv, G, hd).to(dtype)
    kc, vc = (_randn(gen, 2, b, S, Kv, hd)[1].to(dtype) for _ in range(2))
    kb, vb = (_randn(gen, b, Bq, Kv, hd).to(dtype) for _ in range(2))
    lens = torch.tensor([512, 513, 527, 544, 559, 560, 574, 575],
                        dtype=torch.int32, device=cuda)
    got = decode_attention(q, kc, vc, kb, vb, lens, scale=hd ** -0.5)
    want = dref.decode_attention(q, kc, vc, kb, vb, lens, scale=hd ** -0.5)
    # both sides read the same inputs and accumulate in fp32
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def _paged_case(gen, dev, *, b, Bq, Kv, G, hd, page, n_t, lens, dtype):
    """Pools of 3 * b * n_t pages, each lane's pages scattered over them,
    -1 past each lane's length."""
    n_pages = 3 * b * n_t
    q = _randn(gen, b, Bq, Kv, G, hd).to(dtype)
    kp, vp = (_randn(gen, 2, n_pages, page, Kv, hd)[1].to(dtype)
              for _ in range(2))
    kb, vb = (_randn(gen, b, Bq, Kv, hd).to(dtype) for _ in range(2))
    perm = torch.randperm(n_pages, generator=gen, device=dev)
    table = torch.full((b, n_t), -1, dtype=torch.int32, device=dev)
    for lane, ln in enumerate(lens):
        n = -(-ln // page)
        table[lane, :n] = perm[lane * n_t:lane * n_t + n].to(torch.int32)
    lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    return q, kp, vp, kb, vb, table, lens


@pytest.mark.cuda
@pytest.mark.parametrize("G,hd,page,window,softcap,dtype", [
    (2, 64, 32, None, None, torch.float32),
    (7, 64, 16, 6, None, torch.float32),
    (2, 128, 5, None, 5.0, torch.float32),
    (7, 128, 32, 6, 5.0, torch.bfloat16),
    (7, 64, 32, None, None, torch.bfloat16),
    (1, 128, 7, None, None, torch.bfloat16),
])
def test_paged_decode_kernel_matches_plain(cuda, G, hd, page, window,
                                           softcap, dtype):
    gen = torch.Generator(device=cuda).manual_seed(G + hd + page)
    args = _paged_case(gen, cuda, b=4, Bq=8, Kv=2, G=G, hd=hd, page=page,
                       n_t=-(-80 // page), lens=[0, 5, 33, 80], dtype=dtype)
    kw = dict(scale=hd ** -0.5, softcap=softcap, window=window)
    before = paged_decode_attention.launches
    got = paged_decode_attention(*args, **kw)
    assert paged_decode_attention.launches == before + 1
    want = dref.paged_decode_attention(*args, **kw)
    # both sides read the same inputs and accumulate in fp32
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("page", [32, 16, 7])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_equals_dense_kernel_bitwise(cuda, page, dtype):
    """An identity table over a pool holding the dense cache's rows, and a
    permuted table over the same contents moved page by page: the paged
    kernel's output equals the dense kernel's bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(page)
    b, Bq, Kv, G, hd, n_t = 3, 32, 2, 7, 64, 6
    S = n_t * page
    q = _randn(gen, b, Bq, Kv, G, hd).to(dtype)
    kc, vc = (_randn(gen, b, S, Kv, hd).to(dtype) for _ in range(2))
    kb, vb = (_randn(gen, b, Bq, Kv, hd).to(dtype) for _ in range(2))
    lens = torch.tensor([S, page + 3, 2 * page], dtype=torch.int32,
                        device=cuda)
    for kw in ({}, {"window": 2 * page, "softcap": 5.0}):
        kw["scale"] = hd ** -0.5
        dense = decode_attention(q, kc, vc, kb, vb, lens, **kw)
        ident = torch.arange(b * n_t, dtype=torch.int32,
                             device=cuda).reshape(b, n_t)
        kp = kc.reshape(b * n_t, page, Kv, hd)
        vp = vc.reshape(b * n_t, page, Kv, hd)
        assert torch.equal(paged_decode_attention(q, kp, vp, kb, vb, ident,
                                                  lens, **kw), dense)
        perm = torch.randperm(b * n_t, generator=gen, device=cuda)
        kq, vq = torch.empty_like(kp), torch.empty_like(vp)
        kq[perm], vq[perm] = kp, vp           # page i moves to perm[i]
        table = perm.to(torch.int32).reshape(b, n_t)
        assert torch.equal(paged_decode_attention(q, kq, vq, kb, vb, table,
                                                  lens, **kw), dense)


def _decode_pair(cuda, gen, *, b, Bq, Kv, G, hd, S, lens, dtype, page):
    """Dense inputs with S cache rows, and a shuffled pool of pages of
    `page` rows holding the same rows (-1 past each lane's length)."""
    q = _randn(gen, b, Bq, Kv, G, hd).to(dtype)
    kc, vc = (_randn(gen, b, S, Kv, hd).to(dtype) for _ in range(2))
    kb, vb = (_randn(gen, b, Bq, Kv, hd).to(dtype) for _ in range(2))
    n_t = S // page
    perm = torch.randperm(2 * b * n_t, generator=gen, device=cuda)[:b * n_t]
    kp, vp = (torch.zeros((2 * b * n_t, page, Kv, hd), dtype=dtype,
                          device=cuda) for _ in range(2))
    kp[perm], vp[perm] = (x.reshape(b * n_t, page, Kv, hd) for x in (kc, vc))
    lens = torch.tensor(lens, dtype=torch.int32, device=cuda)
    table = perm.to(torch.int32).reshape(b, n_t).clone()
    table[torch.arange(n_t, device=cuda)[None, :] * page
          >= lens[:, None]] = -1
    return (q, kc, vc, kb, vb, lens), (q, kp, vp, kb, vb, table, lens)


@pytest.mark.cuda
@pytest.mark.parametrize("Kv,G,hd", [(2, 7, 64), (4, 7, 128), (32, 1, 128),
                                     (2, 1, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernels_at_split_edges(cuda, Kv, G, hd, dtype):
    """Lengths on the bf16 route's first split edge (ref.tiles_per_split
    tiles of 64 keys), one past it, 0, and S, with S not a multiple of 64:
    both kernels against their plain versions, paged equal to dense."""
    gen = torch.Generator(device=cuda).manual_seed(Kv + G + hd)
    edge = dref.tiles_per_split(Kv, 32 * G) * 64
    S = edge + 40
    dense, paged = _decode_pair(cuda, gen, b=4, Bq=32, Kv=Kv, G=G, hd=hd,
                                S=S, lens=[0, edge, edge + 1, S],
                                dtype=dtype, page=8)
    kw = dict(scale=hd ** -0.5)
    got = decode_attention(*dense, **kw)
    torch.testing.assert_close(got, dref.decode_attention(*dense, **kw),
                               rtol=1e-4, atol=1e-4)
    got_paged = paged_decode_attention(*paged, **kw)
    torch.testing.assert_close(got_paged,
                               dref.paged_decode_attention(*paged, **kw),
                               rtol=1e-4, atol=1e-4)
    assert torch.equal(got_paged, got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernels_ignore_nan_residue(cuda, dtype):
    """NaN in every cache row and pool row at or past each lane's length
    (and in the pages no lane holds): the outputs are finite and equal the
    outputs over a zero residue, dense and paged."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    b, S, page = 4, 200, 8
    lens = [0, 128, 129, 77]
    dense, paged = _decode_pair(cuda, gen, b=b, Bq=32, Kv=2, G=7, hd=64,
                                S=S, lens=lens, dtype=dtype, page=page)
    kw = dict(scale=0.125, window=150)
    want = decode_attention(*dense, **kw)
    want_paged = paged_decode_attention(*paged, **kw)
    q, kc, vc, kb, vb, cl = dense
    past = torch.arange(S, device=cuda)[None, :] >= cl[:, None]
    kc, vc = kc.clone(), vc.clone()
    kc[past], vc[past] = float("nan"), float("nan")
    got = decode_attention(q, kc, vc, kb, vb, cl, **kw)
    _, kp, vp, _, _, table, _ = paged
    kp, vp = kp.clone(), vp.clone()
    held = torch.zeros(kp.shape[:2], dtype=torch.bool, device=cuda)
    for lane, n in enumerate(lens):
        for j in range(-(-n // page)):
            rows = min(page, n - j * page)
            held[table[lane, j], :rows] = True
    kp[~held], vp[~held] = float("nan"), float("nan")
    got_paged = paged_decode_attention(q, kp, vp, kb, vb, table, cl, **kw)
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, want)
    assert torch.equal(got_paged, want_paged)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128])
def test_decode_kernels_are_deterministic(cuda, hd):
    """Two calls give the same bits (the splits merge in order, no
    atomics on values)."""
    gen = torch.Generator(device=cuda).manual_seed(hd)
    dense, paged = _decode_pair(cuda, gen, b=8, Bq=32, Kv=2, G=7, hd=hd,
                                S=768, lens=[0, 512, 536, 577, 608, 640,
                                             700, 736],
                                dtype=torch.bfloat16, page=32)
    for fn, args in ((decode_attention, dense),
                     (paged_decode_attention, paged)):
        first = fn(*args, scale=hd ** -0.5)
        assert torch.equal(fn(*args, scale=hd ** -0.5), first)


@pytest.mark.cuda
def test_decode_kernel_reads_rows_that_are_not_16_byte_aligned(cuda):
    """The bf16 kernel streams rows with 16-byte copies where every row is
    16-byte aligned; a cache viewed at a 2-byte offset takes 2-byte loads
    and gives the plain version's result."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    b, Bq, Kv, G, hd, S = 2, 32, 2, 7, 64, 100
    q = _randn(gen, b, Bq, Kv, G, hd).bfloat16()
    n = b * S * Kv * hd
    kc, vc = (_randn(gen, n + 1).bfloat16()[1:].view(b, S, Kv, hd)
              for _ in range(2))
    kb, vb = (_randn(gen, b, Bq, Kv, hd).bfloat16() for _ in range(2))
    lens = torch.tensor([70, 100], dtype=torch.int32, device=cuda)
    got = decode_attention(q, kc, vc, kb, vb, lens, scale=0.125)
    torch.testing.assert_close(
        got, dref.decode_attention(q, kc, vc, kb, vb, lens, scale=0.125),
        rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,L,G,hd,P,bs,window,softcap,dtype", [
    ("block_causal", 96, 7, 64, 96, 32, None, None, torch.bfloat16),
    ("block_causal", 101, 7, 64, 40, 16, None, None, torch.float32),
    ("block_causal", 77, 3, 128, 20, 8, 12, 5.0, torch.float32),
    ("causal", 70, 2, 64, 0, 1, None, 3.0, torch.float32),
    ("causal", 64, 4, 128, 0, 1, 9, None, torch.bfloat16),
    ("bidirectional", 45, 2, 64, 0, 1, None, None, torch.float32),
    ("bidirectional", 64, 5, 64, 0, 1, 10, None, torch.float32),
    # the bf16 route (tensor cores): L * G not a multiple of the 128-row
    # block, L not a multiple of the 64-key tile, hd 128, a window, a
    # softcap, the prompt ending inside a key tile, the prefill's
    # all-visible tiles, the collector's bidirectional canvas
    ("block_causal", 100, 7, 64, 40, 16, None, None, torch.bfloat16),
    ("causal", 96, 7, 128, 0, 1, None, None, torch.bfloat16),
    ("block_causal", 130, 7, 64, 50, 16, 20, None, torch.bfloat16),
    ("bidirectional", 70, 7, 128, 0, 1, None, 5.0, torch.bfloat16),
    ("causal", 77, 4, 128, 0, 1, 9, 3.0, torch.bfloat16),
    ("block_causal", 512, 7, 64, 512, 32, None, None, torch.bfloat16),
    ("bidirectional", 384, 7, 64, 128, 32, None, None, torch.bfloat16),
    # the baseline decoders' forwards: ar's causal prompt prefill, and
    # fast_dllm's canvas (P=512 + G=64) every iteration
    ("causal", 512, 7, 64, 0, 1, None, None, torch.bfloat16),
    ("bidirectional", 576, 7, 64, 512, 32, None, None, torch.bfloat16),
])
def test_block_attention_kernel_matches_plain(cuda, mode, L, G, hd, P, bs,
                                              window, softcap, dtype):
    gen = torch.Generator(device=cuda).manual_seed(L + G)
    b, Kv = 2, 2
    q = _randn(gen, b, L, Kv, G, hd).to(dtype)
    k, v = (_randn(gen, b, L, Kv, hd).to(dtype) for _ in range(2))
    kw = dict(mode=mode, prompt_len=P, block_size=bs, window=window,
              scale=hd ** -0.5, softcap=softcap)
    before = flash_block_attention.launches
    got = flash_block_attention(q, k, v, **kw)
    assert flash_block_attention.launches == before + 1
    want = bref.block_attention(q, k, v, **kw)
    # both sides read the same inputs and keep scores in fp32; the bf16
    # kernel's probabilities enter the PV product as a bf16 pair (about
    # 2^-18 relative), the others' in fp32
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_block_attention_keys_past_L_get_probability_zero(cuda):
    """A key tile that runs past L reads the next lane's rows (or TMA's zero
    fill for the last lane); those keys must weigh exactly 0. Lane 1's keys
    and values are huge: any weight on them would show in lane 0."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    b, L, Kv, G, hd = 2, 70, 2, 7, 64
    q = _randn(gen, b, L, Kv, G, hd).bfloat16()
    k, v = (_randn(gen, b, L, Kv, hd) for _ in range(2))
    k[1] *= 100.0
    v[1] = 1e30
    k, v = k.bfloat16(), v.bfloat16()
    for mode in ("bidirectional", "causal"):
        kw = dict(mode=mode, scale=hd ** -0.5)
        got = flash_block_attention(q, k, v, **kw)
        want = bref.block_attention(q[:1], k[:1], v[:1], **kw)
        torch.testing.assert_close(got[:1], want, rtol=1e-4, atol=1e-4)
        assert bool(torch.isfinite(got[1]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("T,d,V,softcap,dtype", [
    (64, 32, 593, None, torch.float32),
    (40, 48, 1000, 30.0, torch.float32),
    (300, 64, 5000, None, torch.float32),
    (256, 128, 7001, None, torch.bfloat16),
])
def test_select_kernel_matches_plain(cuda, T, d, V, softcap, dtype):
    gen = torch.Generator(device=cuda).manual_seed(T + V)
    h = (_randn(gen, T, d) * 0.5).to(dtype)
    w = (_randn(gen, V, d) * 0.1).to(dtype)
    masked = torch.rand((T,), generator=gen, device=cuda) < 0.7
    w[3] = w[V - 2] = (h[0].float().sign()).to(dtype)    # cross-chunk tie
    before = fused_select.launches
    cand, conf = fused_select(h, w, masked, softcap=softcap)
    assert fused_select.launches == before + 1
    want_c, want_f = sref.select_ref(h, w, masked, softcap=softcap)
    assert int(cand[0]) == 3
    assert torch.equal(cand, want_c)
    assert torch.equal(torch.isfinite(conf), masked)
    fin = torch.isfinite(want_f)
    torch.testing.assert_close(conf[fin], want_f[fin], rtol=1e-4, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("T,d,V,w_scale,softcap", [
    (32, 128, 5001, 0.1, None),     # one partial row tile, ragged vocab
    (300, 128, 5001, 0.1, None),    # three row tiles, the last partial
    (300, 64, 2000, 1.0, None),     # sharp: W unscaled
    (130, 256, 1000, 0.1, 30.0),    # softcap
])
def test_select_tensor_core_route_ties_and_edges(cuda, T, d, V, w_scale,
                                                 softcap):
    """Planted exact ties resolve to the lower index: row 0 across vocab
    chunks, row 1 across the two 64-column halves of one 128-column tile
    (columns 444 and 450), row 2 across the lanes of a quad (columns 646 in
    lane 3 and 649 in lane 0). The planted rows are the row's own hidden
    state, scaled: its logit there is far above its others, and other rows'
    logits there stay below their maxima. Elsewhere the candidates equal the
    plain version's, but at a near-tie (top-2 logit gap under 1e-4)."""
    gen = torch.Generator(device=cuda).manual_seed(T + V + d)
    h = (_randn(gen, T, d) * 0.5).bfloat16()
    w = (_randn(gen, V, d) * w_scale).bfloat16()
    masked = torch.rand((T,), generator=gen, device=cuda) < 0.7
    planted = {0: (3, V - 2), 1: (444, 450), 2: (646, 649)}
    for row, cols in planted.items():
        w[list(cols)] = (h[row].float() * 1.5 * w_scale).bfloat16()
    before = fused_select.launches
    cand, conf = fused_select(h, w, masked, softcap=softcap)
    assert fused_select.launches == before + 1
    want_c, want_f = sref.select_ref(h, w, masked, softcap=softcap)
    for row, cols in planted.items():
        assert int(cand[row]) == min(cols), row
    logits = h.float() @ w.float().t()
    top2 = logits.topk(2, dim=-1).values
    differ = cand != want_c
    assert bool((top2[:, 0] - top2[:, 1])[differ].lt(1e-4).all())
    assert torch.equal(torch.isfinite(conf), masked)
    same = torch.isfinite(want_f) & ~differ
    torch.testing.assert_close(conf[same], want_f[same], rtol=1e-4, atol=0)


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q = torch.zeros((1, 4, 1, 1, 96), device=cuda)        # head_dim 96
    kv = torch.zeros((1, 8, 1, 96), device=cuda)
    blk = torch.zeros((1, 4, 1, 96), device=cuda)
    lens = torch.zeros((1,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        decode_attention(q, kv, kv, blk, blk, lens)
    with pytest.raises(ValueError, match="head_dim"):
        paged_decode_attention(q, kv, kv, blk, blk,
                               torch.zeros((1, 2), dtype=torch.int32,
                                           device=cuda), lens)
    q64 = torch.zeros((1, 4, 1, 1, 64), device=cuda)
    pool = torch.zeros((3, 4, 1, 64), device=cuda)
    blk64 = torch.zeros((1, 4, 1, 64), device=cuda)
    with pytest.raises(ValueError, match="page_table"):
        paged_decode_attention(q64, pool, pool, blk64, blk64,
                               torch.zeros((1, 2), dtype=torch.int64,
                                           device=cuda), lens)
    with pytest.raises(ValueError, match="dtype"):
        paged_decode_attention(q64.bfloat16(), pool, pool, blk64, blk64,
                               torch.zeros((1, 2), dtype=torch.int32,
                                           device=cuda), lens)
    kv64 = torch.zeros((1, 4, 1, 64), device=cuda)
    with pytest.raises(ValueError, match="mode"):
        flash_block_attention(q64, kv64, kv64, mode="sliding")
    with pytest.raises(ValueError, match="head_dim"):
        flash_block_attention(q, blk, blk)
    strided = torch.zeros((1, 4, 1, 128), device=cuda)[..., :64]
    with pytest.raises(ValueError, match="contiguous"):
        flash_block_attention(q64, strided, strided)
    with pytest.raises(ValueError, match="positive"):
        flash_block_attention(q64, kv64, kv64, window=0)
    h = torch.zeros((4, 12), device=cuda)                   # d % 8 != 0
    with pytest.raises(ValueError, match="multiple of 8"):
        fused_select(h, torch.zeros((10, 12), device=cuda),
                     torch.ones((4,), dtype=torch.bool, device=cuda))
    # the bf16 (tensor-core) routes
    bf = torch.bfloat16
    with pytest.raises(ValueError, match="head_dim"):
        flash_block_attention(q.to(bf), blk.to(bf), blk.to(bf))
    buf = torch.zeros((4 * 64 + 8,), dtype=bf, device=cuda)
    off = buf[1:1 + 4 * 64].view(1, 4, 1, 64)              # 2-byte offset
    with pytest.raises(ValueError, match="aligned"):
        flash_block_attention(q64.to(bf), off, kv64.to(bf))
    ones = torch.ones((4,), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="multiple of 8"):
        fused_select(h.to(bf), torch.zeros((10, 12), dtype=bf, device=cuda),
                     ones)
    with pytest.raises(ValueError, match="aligned"):
        fused_select(buf[1:1 + 4 * 64].view(4, 64),
                     torch.zeros((10, 64), dtype=bf, device=cuda), ones)


# the head layouts the kernels gained: gemma-7b (Kv 16, G 1, hd 256),
# kimi-k2 (Kv 8, G 8, hd 112: padded to 128 inside the kernels) and
# jamba's attention slot (Kv 8, G 4, hd 128)
NEW_HEADS = [(16, 1, 256), (8, 8, 112), (8, 4, 128)]
NEW_IDS = ["gemma-7b-hd256", "kimi-k2-hd112", "jamba-hd128"]


@pytest.mark.cuda
@pytest.mark.parametrize("Kv,G,hd", NEW_HEADS, ids=NEW_IDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window,softcap", [(None, None), (40, 50.0)])
def test_decode_kernels_at_new_head_dims(cuda, Kv, G, hd, dtype, window,
                                         softcap):
    """Dense and paged decode attention at hd 256 and 112 against their
    plain versions (1e-4: both sides read the same inputs and accumulate
    in fp32), lengths 0, on a 64-key tile edge, past it and S; the paged
    kernel equal to the dense one bit for bit, and two calls equal."""
    gen = torch.Generator(device=cuda).manual_seed(Kv + G + hd)
    dense, paged = _decode_pair(cuda, gen, b=4, Bq=32, Kv=Kv, G=G, hd=hd,
                                S=200, lens=[0, 64, 129, 200], dtype=dtype,
                                page=8)
    kw = dict(scale=hd ** -0.5, window=window, softcap=softcap)
    got = decode_attention(*dense, **kw)
    torch.testing.assert_close(got, dref.decode_attention(*dense, **kw),
                               rtol=1e-4, atol=1e-4)
    got_paged = paged_decode_attention(*paged, **kw)
    torch.testing.assert_close(got_paged,
                               dref.paged_decode_attention(*paged, **kw),
                               rtol=1e-4, atol=1e-4)
    assert torch.equal(got_paged, got)
    assert torch.equal(decode_attention(*dense, **kw), got)


@pytest.mark.cuda
@pytest.mark.parametrize("Kv,G,hd", NEW_HEADS, ids=NEW_IDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode,L,P,bs,window,softcap", [
    ("block_causal", 100, 40, 16, None, None),
    ("bidirectional", 70, 0, 1, 20, 50.0),     # gemma2's softcap, a window
    ("causal", 130, 0, 1, None, None),
])
def test_block_attention_at_new_head_dims(cuda, Kv, G, hd, dtype, mode, L,
                                          P, bs, window, softcap):
    """Block attention at hd 256 (64 rows a block, O split in column
    halves) and 112 (K/V by 3-D TMA boxes zero-filled past 112) against
    the plain version, L not a multiple of the key tile."""
    gen = torch.Generator(device=cuda).manual_seed(L + hd)
    q = _randn(gen, 2, L, Kv, G, hd).to(dtype)
    k, v = (_randn(gen, 2, L, Kv, hd).to(dtype) for _ in range(2))
    kw = dict(mode=mode, prompt_len=P, block_size=bs, window=window,
              scale=hd ** -0.5, softcap=softcap)
    got = flash_block_attention(q, k, v, **kw)
    torch.testing.assert_close(got, bref.block_attention(q, k, v, **kw),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [96, 120, 192, 320])
def test_wrappers_refuse_head_dims_they_do_not_take(cuda, hd):
    """The kernels take head_dim 64, 112, 128 and 256; the wrappers raise on
    any other, in both dtypes, rather than pad or fall back."""
    from repro_torch.kernels.block_attn import ops as bops
    from repro_torch.kernels.decode_attn import ops as dops
    assert dops.HEAD_DIMS == bops.HEAD_DIMS == (64, 112, 128, 256)
    lens = torch.zeros((1,), dtype=torch.int32, device=cuda)
    table = torch.zeros((1, 2), dtype=torch.int32, device=cuda)
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.zeros((1, 4, 1, 1, hd), dtype=dtype, device=cuda)
        kv = torch.zeros((1, 8, 1, hd), dtype=dtype, device=cuda)
        blk = torch.zeros((1, 4, 1, hd), dtype=dtype, device=cuda)
        with pytest.raises(ValueError, match="head_dim"):
            decode_attention(q, kv, kv, blk, blk, lens)
        with pytest.raises(ValueError, match="head_dim"):
            paged_decode_attention(q, kv, kv, blk, blk, table, lens)
        with pytest.raises(ValueError, match="head_dim"):
            flash_block_attention(q, blk, blk)


def _xent_case(cuda, T, d, V, dtype, seed, w_scale=0.3):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    h = _randn(gen, T, d).to(dtype)
    w = (_randn(gen, V, d) * w_scale).to(dtype)
    y = torch.randint(0, V, (T,), generator=gen, device=cuda)
    y[:2] = torch.tensor([0, V - 1], device=cuda)          # vocab edges
    g = torch.rand((T,), generator=gen, device=cuda) + 0.2
    g[::5] = 0.0                                           # rows with g = 0
    return h, w, y, g


def _grad_close(got, want, dtype):
    """fp32: both sides sum fp32 products in other orders, within 1e-5 of
    max|grad|; bf16 outputs: the fp32 sums round to bf16, one bf16 ulp
    (2^-8 relative) apart at most."""
    scale = float(want.float().abs().max())
    torch.testing.assert_close(
        got.float(), want.float(), atol=1e-5 * scale,
        rtol=0 if dtype == torch.float32 else 2 ** -7)


@pytest.mark.cuda
@pytest.mark.parametrize("T,d,V,chunk_elems,dtype,w_scale", [
    (128, 64, 512, None, torch.float32, 0.3),
    (200, 32, 1000, None, torch.float32, 0.3),
    (64, 128, 593, None, torch.bfloat16, 0.3),
    (300, 96, 5003, 300 * 128, torch.float32, 0.3),     # 40 backward chunks
    (256, 896, 9000, 256 * 1024, torch.bfloat16, 0.3),  # ragged last chunk
    (300, 96, 5003, 300 * 128, torch.bfloat16, 0.3),    # 40 chunks, ragged T
    (1100, 64, 3001, None, torch.bfloat16, 0.3),   # dW targets in 2 passes
    # sharp: W unscaled, logits of std ~30, a nearly one-hot softmax whose
    # dh cancels against g W_y; one bf16 rounding of the probabilities
    # fails the limit here, the bf16 pair holds it
    (256, 896, 9000, 256 * 1024, torch.bfloat16, 1.0),
])
def test_xent_kernels_match_plain(cuda, monkeypatch, T, d, V, chunk_elems,
                                  dtype, w_scale):
    if chunk_elems is not None:    # the scratch holds 4 bytes an element
        monkeypatch.setattr(xops, "PROBS_BYTES", 4 * chunk_elems)
    h, w, y, g = _xent_case(cuda, T, d, V, dtype, T + V, w_scale)
    if w_scale == 1.0:             # half the targets on the argmax
        top = (h.float() @ w.float().t()).argmax(-1)
        y[3::2] = top[3::2]
    before = (fused_xent.launches, fused_xent.backward_launches)
    hh, ww = h.clone().requires_grad_(), w.clone().requires_grad_()
    loss = fused_xent(hh, ww, y)
    dh, dw = torch.autograd.grad((loss * g).sum(), (hh, ww))
    assert (fused_xent.launches, fused_xent.backward_launches) == \
        (before[0] + 1, before[1] + 1)
    want_loss, want_logz = xref.xent_streaming(h, w, y)
    want_dh, want_dw = xref.xent_backward(h, w, y, g, want_logz)
    # both sides read the same inputs and accumulate in fp32
    torch.testing.assert_close(loss, want_loss, rtol=0, atol=1e-4)
    torch.testing.assert_close(loss, xref.xent_ref(h, w, y), rtol=0,
                               atol=1e-4)
    assert dh.dtype == dtype and dw.dtype == dtype
    _grad_close(dh, want_dh, dtype)
    _grad_close(dw, want_dw, dtype)
    assert torch.all(dh[::5] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_xent_backward_is_deterministic(cuda, monkeypatch, dtype):
    monkeypatch.setattr(xops, "PROBS_BYTES", 4 * 256 * 512)
    h, w, y, g = _xent_case(cuda, 256, 128, 3001, dtype, 7)
    runs = []
    for _ in range(2):
        hh, ww = h.clone().requires_grad_(), w.clone().requires_grad_()
        runs.append(torch.autograd.grad((fused_xent(hh, ww, y) * g).sum(),
                                        (hh, ww)))
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_xent_frozen_head_skips_dw(cuda, dtype):
    h, w, y, g = _xent_case(cuda, 64, 64, 700, dtype, 3)
    hh = h.clone().requires_grad_()
    (dh,) = torch.autograd.grad((fused_xent(hh, w, y) * g).sum(), (hh,))
    _grad_close(dh, xref.xent_backward(h, w, y, g, need_dw=False)[0], dtype)


@pytest.mark.cuda
def test_kernel_wrappers_refuse_grad_on_cuda(cuda):
    """The attention and select kernels have no backward: with grad mode on
    and an input that requires grad they raise before any launch; under
    no_grad they launch."""
    q = torch.zeros((1, 4, 1, 2, 64), device=cuda, requires_grad=True)
    blk = torch.zeros((1, 4, 1, 64), device=cuda)
    cache = torch.zeros((1, 8, 1, 64), device=cuda)
    lens = torch.full((1,), 3, dtype=torch.int32, device=cuda)
    table = torch.zeros((1, 1), dtype=torch.int32, device=cuda)
    pool = torch.zeros((1, 8, 1, 64), device=cuda)
    h = torch.zeros((4, 64), device=cuda, requires_grad=True)
    w = torch.zeros((10, 64), device=cuda)
    qb = q.detach().bfloat16().requires_grad_()
    hb = h.detach().bfloat16().requires_grad_()
    calls = {
        "decode_attention": (decode_attention, lambda: decode_attention(
            q, cache, cache, blk, blk, lens)),
        "paged_decode_attention": (paged_decode_attention,
                                   lambda: paged_decode_attention(
                                       q, pool, pool, blk, blk, table, lens)),
        "flash_block_attention": (flash_block_attention,
                                  lambda: flash_block_attention(
                                      q, blk, blk, mode="bidirectional")),
        "fused_select": (fused_select, lambda: fused_select(
            h, w, torch.ones((4,), dtype=torch.bool, device=cuda))),
        # the bf16 (tensor-core) routes
        "decode_attention bf16": (decode_attention, lambda: decode_attention(
            qb, cache.bfloat16(), cache.bfloat16(), blk.bfloat16(),
            blk.bfloat16(), lens)),
        "paged_decode_attention bf16": (
            paged_decode_attention, lambda: paged_decode_attention(
                qb, pool.bfloat16(), pool.bfloat16(), blk.bfloat16(),
                blk.bfloat16(), table, lens)),
        "flash_block_attention bf16": (
            flash_block_attention, lambda: flash_block_attention(
                qb, blk.bfloat16(), blk.bfloat16(), mode="bidirectional")),
        "fused_select bf16": (fused_select, lambda: fused_select(
            hb, w.bfloat16(), torch.ones((4,), dtype=torch.bool,
                                         device=cuda))),
    }
    for name, (fn, call) in calls.items():
        before = fn.launches
        with pytest.raises(RuntimeError, match="no backward"):
            call()
        assert fn.launches == before, name
        with torch.no_grad():
            call()
        torch.cuda.synchronize()
        assert fn.launches == before + 1, name


# ---------------------------------------------------------------------------
# CUDA graphs of the block decode and the collector against the eager path
# ---------------------------------------------------------------------------
def _reduced_params(cuda, dtype="float32"):
    from repro_torch.bridge import init_params
    from repro_torch.configs import get_config
    cfg = get_config("qwen2-0.5b").reduced(dtype=dtype)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         cuda, dtype)
    with torch.no_grad():
        params["embed"]["tok"] *= 40.0   # a sharp head: >1 token an iteration
        params["embed"]["tok"][cfg.mask_token_id] = 0
    return cfg, params


def _counted(fn):
    """fn() with every kernel's launch counter from 0; (result, counts)."""
    from repro_torch.graphs import COUNTERS
    for wrapper, attr in COUNTERS:
        setattr(wrapper, attr, 0)
    out = fn()
    torch.cuda.synchronize()
    return out, [getattr(wrapper, attr) for wrapper, attr in COUNTERS]


@pytest.mark.cuda
@pytest.mark.parametrize("layout,pool", [("dense", None), ("paged", None),
                                         ("paged", 8)])
def test_graph_serving_equals_eager(cuda, layout, pool):
    """The engine through its CUDA graphs and eagerly (``graphs=False``) on
    one trace: tokens, steps, gen_length, finish_reason, call counts, page
    statistics and every kernel's launch count equal, and the launches
    equal the call accounting (a tight pool of 8 pages stalls and
    preempts)."""
    import numpy as np

    from repro_torch.configs import ServeConfig
    from repro_torch.serving import ContinuousEngine, Request
    cfg, params = _reduced_params(cuda)
    P, G, B = 8, 16, 4
    serve = ServeConfig(max_batch=2, block_size=B, gen_length=G,
                        conf_threshold=0.5, scheduler="continuous",
                        fused_select=True, cache_layout=layout,
                        page_pool_pages=pool)
    prompts = np.random.default_rng(0).integers(2, cfg.vocab_size - 1,
                                                (5, P))
    caps = [None, B, None, 2 * B, None]
    runs = {}
    for graphs in (False, None):
        eng = ContinuousEngine(params, cfg, serve, prompt_len=P,
                               device=cuda, graphs=graphs)
        eng.warmup()
        assert (eng._graphs is not None) == (graphs is None)
        outs, counts = _counted(lambda: eng.generate(
            [Request(prompt=p, id=i, max_tokens=c)
             for i, (p, c) in enumerate(zip(prompts, caps))]))
        calls = eng.call_counts()
        cached = cfg.n_layers * (calls["refine"] + calls["commit"])
        # COUNTERS order: decode, paged decode, block attention, select,
        # xent forward, xent backward, then the elementwise passes (none
        # at fp32: the plain ops) and the grouped MoE's five (no MoE)
        assert counts == [cached if layout == "dense" else 0,
                          cached if layout == "paged" else 0,
                          cfg.n_layers * calls["admit"], calls["refine"],
                          0, 0, 0, 0, 0] + [0] * 5
        runs[graphs] = ({o.id: o for o in outs}, calls,
                        eng.page_pool_stats(), counts)
    (eager, e_calls, e_stats, e_counts), (graph, g_calls, g_stats, g_counts) \
        = runs[False], runs[None]
    assert sorted(graph) == sorted(eager) == list(range(5))
    for rid, o in eager.items():
        np.testing.assert_array_equal(graph[rid].tokens, o.tokens)
        assert (graph[rid].steps, graph[rid].gen_length,
                graph[rid].finish_reason) == (o.steps, o.gen_length,
                                              o.finish_reason)
    assert (g_calls, g_stats, g_counts) == (e_calls, e_stats, e_counts)
    if pool is not None:
        assert g_stats["preemptions"] >= 1 and g_stats["stall_rounds"] >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_graph_collector_equals_eager(cuda, dtype):
    """The greedy collector with its forward as a CUDA graph and eagerly:
    tokens, finalized_at and hidden bit for bit, and the same launches
    (one block attention per layer and one select per step)."""
    from repro_torch.core.block_loop import SamplerSpec, _top1_loop
    cfg, params = _reduced_params(cuda, dtype)
    P, G, B = 8, 16, 4
    spec = SamplerSpec(prompt_len=P, gen_len=G, block_size=B,
                       fused_select=True)
    prompts = torch.randint(2, cfg.vocab_size - 1, (3, P), device=cuda,
                            generator=torch.Generator(device=cuda)
                            .manual_seed(1))
    got = {}
    for graphs in (None, False):
        got[graphs] = _counted(lambda: _top1_loop(
            params, prompts, cfg=cfg, spec=spec, record_hidden=True,
            graphs=graphs))
    (res_g, fat_g, hid_g), counts_g = got[None]
    (res_e, fat_e, hid_e), counts_e = got[False]
    assert torch.equal(res_g.tokens, res_e.tokens)
    assert torch.equal(fat_g, fat_e) and torch.equal(hid_g, hid_e)
    # then the elementwise passes per canvas forward (none at fp32)
    passes = ([(2 * cfg.n_layers + 1) * G, cfg.n_layers * G,
               cfg.n_layers * G] if dtype == "bfloat16" else [0, 0, 0])
    assert counts_g == counts_e == [0, 0, G * cfg.n_layers, G, 0, 0] + passes


@pytest.mark.cuda
@pytest.mark.parametrize("partitionable", [True, False])
def test_prng_on_the_card_equals_the_cpu(cuda, partitionable):
    """The threefry keys, bits and uniforms on CUDA equal the CPU's bit for
    bit (int32 wrap-around and masked shifts on both), the Gumbel noise
    within 2 ulp of max(|g|, 1) (the two devices' logs differ)."""
    from repro_torch import prng
    keys = prng.split(prng.key(42), 4)
    for shape in [(7,), (3, 5, 1001)]:
        for fn in (prng.bits, prng.uniform):
            got = fn(keys.to(cuda), shape, partitionable=partitionable)
            assert torch.equal(got.cpu(), fn(keys, shape,
                                              partitionable=partitionable))
        g = prng.gumbel(keys.to(cuda), shape, partitionable=partitionable)
        want = prng.gumbel(keys, shape, partitionable=partitionable)
        ulp = torch.maximum(want.abs(), torch.ones_like(want))
        ulp = torch.nextafter(ulp, torch.full_like(ulp, float("inf"))) - ulp
        assert float(((g.cpu() - want).abs() / ulp).max()) <= 2
    assert torch.equal(prng.split(keys.to(cuda), 3,
                                  partitionable=partitionable).cpu(),
                       prng.split(keys, 3, partitionable=partitionable))


@pytest.mark.cuda
@pytest.mark.parametrize("layout,pool", [("dense", None), ("paged", None),
                                         ("paged", 8)])
@pytest.mark.parametrize("sampled", [False, True],
                         ids=["dense-greedy", "sampled"])
def test_graph_sampled_serving_equals_eager(cuda, layout, pool, sampled):
    """The engine without fused select, through its CUDA graphs and
    eagerly, on a trace of greedy and (``sampled``) seeded sampled
    requests: tokens, steps, call counts, page statistics and launches
    equal, and the launches equal the call accounting (no select)."""
    import numpy as np

    from repro_torch.configs import ServeConfig
    from repro_torch.serving import ContinuousEngine, Request, SamplingParams
    cfg, params = _reduced_params(cuda)
    P, G, B = 8, 16, 4
    serve = ServeConfig(max_batch=2, block_size=B, gen_length=G,
                        conf_threshold=0.5, scheduler="continuous",
                        cache_layout=layout, page_pool_pages=pool)
    prompts = np.random.default_rng(0).integers(2, cfg.vocab_size - 1,
                                                (5, P))
    sps = [None, SamplingParams(temperature=0.8, seed=3), None,
           SamplingParams(temperature=1.2, seed=9), None]
    if not sampled:
        sps = [None] * 5
    runs = {}
    for graphs in (False, None):
        eng = ContinuousEngine(params, cfg, serve, prompt_len=P,
                               device=cuda, graphs=graphs)
        eng.warmup(per_request=True)
        outs, counts = _counted(lambda: eng.generate(
            [Request(prompt=p, id=i, params=sp)
             for i, (p, sp) in enumerate(zip(prompts, sps))]))
        calls = eng.call_counts()
        cached = cfg.n_layers * (calls["refine"] + calls["commit"])
        assert counts == [cached if layout == "dense" else 0,
                          cached if layout == "paged" else 0,
                          cfg.n_layers * calls["admit"], 0, 0, 0, 0, 0,
                          0] + [0] * 5
        runs[graphs] = ({o.id: (o.tokens.tolist(), o.steps, o.gen_length,
                                o.finish_reason) for o in outs}, calls,
                        eng.page_pool_stats(), counts)
        if graphs is None:
            assert set(eng._graphs) == {"dense", "sampled", "commit"}
    assert runs[None] == runs[False]
    if pool is not None:
        assert runs[None][2]["preemptions"] >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_graph_sampled_collection_equals_eager(cuda, dtype):
    """Collection at temperature 0.5 with the forward as a CUDA graph and
    eagerly, from one key: tokens, finalized_at and hidden bit for bit,
    and the same launches (block attention per layer and step; a sampled
    step selects from dense logits, so no select)."""
    from repro_torch import prng
    from repro_torch.core.block_loop import SamplerSpec, _top1_loop
    cfg, params = _reduced_params(cuda, dtype)
    P, G, B = 8, 16, 4
    spec = SamplerSpec(prompt_len=P, gen_len=G, block_size=B,
                       temperature=0.5, fused_select=True)
    prompts = torch.randint(2, cfg.vocab_size - 1, (3, P), device=cuda,
                            generator=torch.Generator(device=cuda)
                            .manual_seed(1))
    got = {}
    for graphs in (None, False):
        got[graphs] = _counted(lambda: _top1_loop(
            params, prompts, cfg=cfg, spec=spec, record_hidden=True,
            key=prng.key(5, cuda), graphs=graphs))
    (res_g, fat_g, hid_g), counts_g = got[None]
    (res_e, fat_e, hid_e), counts_e = got[False]
    assert torch.equal(res_g.tokens, res_e.tokens)
    assert torch.equal(fat_g, fat_e) and torch.equal(hid_g, hid_e)
    # then the elementwise passes, per canvas forward: two add + norms a
    # layer and the final norm, one QKV bias + RoPE and one gated
    # activation a layer; none at fp32 (the plain ops)
    passes = ([(2 * cfg.n_layers + 1) * G, cfg.n_layers * G,
               cfg.n_layers * G] if dtype == "bfloat16" else [0, 0, 0])
    assert counts_g == counts_e == [0, 0, G * cfg.n_layers, 0, 0, 0] + passes


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fast_dllm", "dual_cache",
                                  "interval_cache", "ar"])
def test_baseline_decoder_kernel_path_equals_plain(cuda, name):
    """A baseline decoder at fp32 with the kernels and with their plain
    versions (``run_block_loop(attention_fns=...)``): tokens, steps, calls
    and gen_lengths equal; the plain run launches no attention kernel, the
    kernel run the block attention (and, for ar, the decode attention)."""
    from repro_torch.core.block_loop import (
        KERNELS,
        PLAIN,
        STRATEGIES,
        SamplerSpec,
        run_block_loop,
    )
    cfg, params = _reduced_params(cuda)
    spec = SamplerSpec(prompt_len=8, gen_len=16, block_size=8,
                       conf_threshold=0.5, cache_refresh_interval=2,
                       fused_select=True)
    prompts = torch.randint(2, cfg.vocab_size - 1, (3, 8), device=cuda,
                            generator=torch.Generator(device=cuda)
                            .manual_seed(2))
    (kern, k_counts), (plain, p_counts) = (
        _counted(lambda: run_block_loop(params, prompts, cfg=cfg, spec=spec,
                                        strategy=STRATEGIES[name],
                                        attention_fns=fns))
        for fns in (KERNELS, PLAIN))
    assert torch.equal(kern.tokens, plain.tokens)
    assert torch.equal(kern.steps, plain.steps)
    assert torch.equal(kern.gen_lengths, plain.gen_lengths)
    assert kern.n_model_calls == plain.n_model_calls
    # COUNTERS order: decode, paged decode, block attention, select, xent
    assert p_counts[:3] == [0, 0, 0] and k_counts[2] > 0
    assert (k_counts[0] > 0) == (name == "ar")


# the static engine's CUDA graphs: each decoder's steps captured once per
# engine and replayed for every batch, against the same engine eagerly
STATIC_THRESHOLD = ("fast_dllm", "dual_cache", "interval_cache", "cdlm")
STATIC_CASES = (
    [(n, "dense", "greedy-fused") for n in
     ("vanilla", "fast_dllm", "dual_cache", "interval_cache", "cdlm", "ar")]
    + [(n, "dense", c) for n in ("vanilla",) + STATIC_THRESHOLD
       for c in ("greedy-dense", "sampled")]
    + [(n, "dense", c) for n in STATIC_THRESHOLD
       for c in ("lanes-greedy", "lanes-sampled")]
    + [("cdlm", "paged", c) for c in ("greedy-fused", "greedy-dense",
                                      "sampled", "lanes-greedy",
                                      "lanes-sampled")])


@pytest.mark.cuda
@pytest.mark.parametrize("name,layout,case", STATIC_CASES,
                         ids=[f"{n}-{lay}-{c}" for n, lay, c in
                              STATIC_CASES])
def test_static_graph_equals_eager(cuda, name, layout, case):
    """The static engine through its CUDA graphs and eagerly
    (``graphs=False``) on one trace of three batches (a short last one):
    tokens, steps, gen_length, finish_reason, call counts and every
    kernel's launch count equal; the graph engine captured each of its
    steps once (at warmup), the eager one none."""
    import numpy as np

    from repro_torch.configs import ServeConfig
    from repro_torch.serving import Engine, Request, SamplingParams
    cfg, params = _reduced_params(cuda)
    with torch.no_grad():
        params["embed"]["tok"][cfg.eos_token_id] *= 3.0  # some lanes stop
    P, G, B = 8, 16, 4
    serve = ServeConfig(
        max_batch=2, block_size=B, gen_length=G, conf_threshold=0.5,
        cache_refresh_interval=2, scheduler="static", sampler=name,
        cache_layout=layout, fused_select=case == "greedy-fused",
        temperature=0.7 if case == "sampled" else 0.0)
    prompts = np.random.default_rng(0).integers(2, cfg.vocab_size - 1,
                                                (5, P))
    sps = [None] * 5
    if case.startswith("lanes"):
        sps = [SamplingParams(conf_threshold=0.3), None,
               SamplingParams(temperature=0.8, seed=3)
               if case == "lanes-sampled" else None,
               SamplingParams(temperature=1.2, seed=9)
               if case == "lanes-sampled" else SamplingParams(),
               SamplingParams(conf_threshold=0.7)]
    runs = {}
    for graphs in (False, None):
        eng = Engine(params, cfg, serve, prompt_len=P, device=cuda,
                     graphs=graphs)
        eng.warmup(per_request=True)
        captured = set(eng._graphs or ())
        outs, counts = _counted(lambda: eng.generate(
            [Request(prompt=p, id=i, params=sp, max_tokens=(
                B if i == 1 else None))
             for i, (p, sp) in enumerate(zip(prompts, sps))]))
        assert set(eng._graphs or ()) == captured   # nothing new captured
        runs[graphs] = ({o.id: (o.tokens.tolist(), o.steps, o.gen_length,
                                o.finish_reason) for o in outs},
                        eng.call_counts(), counts)
        if graphs is None:
            assert captured, "the graph engine captured nothing"
    assert runs[None] == runs[False]
    assert sorted(runs[None][0]) == list(range(5))
    # COUNTERS order: decode, paged decode, block attention, select, xent
    # forward, xent backward, the elementwise passes (none at fp32), the
    # grouped MoE's five (no MoE)
    counts = runs[None][2]
    assert (counts[0] > 0) == (name == "ar" or name == "cdlm"
                               and layout == "dense")
    assert (counts[1] > 0) == (name == "cdlm" and layout == "paged")
    assert (counts[2] > 0) == (name != "vanilla" or case == "greedy-fused")
    assert (counts[3] > 0) == (case == "greedy-fused" and name != "ar")
    assert counts[4:] == [0] * 10


# the recurrent-state configs: jamba (Mamba, attention, MoE) and rwkv6
# (attention-free) with their state caches inside the engines' graphs
RECURRENT_CASES = [("jamba-v0.1-52b", "dense"), ("jamba-v0.1-52b", "paged"),
                   ("rwkv6-1.6b", "dense")]


def _recurrent_params(cuda, name):
    from repro_torch.bridge import init_params
    from repro_torch.configs import get_config
    cfg = get_config(name).reduced(dtype="float32")
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         cuda)
    with torch.no_grad():
        params["embed"]["head"] *= 40.0   # a sharp head
        params["embed"]["head"][cfg.mask_token_id] = 0
    return cfg, params


def _attention_layers(cfg):
    from repro_torch.configs.base import ATTN, ATTN_LOCAL
    return cfg.n_periods * sum(m in (ATTN, ATTN_LOCAL)
                               for m, _ in cfg.layer_period)


@pytest.mark.cuda
@pytest.mark.parametrize("name,layout", RECURRENT_CASES,
                         ids=[f"{n}-{lay}" for n, lay in RECURRENT_CASES])
def test_recurrent_graph_serving_equals_eager(cuda, name, layout):
    """The continuous engine through its CUDA graphs and eagerly on one
    trace, with the Mamba or RWKV state carried in the cache: tokens,
    steps, call counts and launches equal, the attention kernels launched
    once per attention layer and cached forward (never for rwkv6), select
    once per iteration."""
    import numpy as np

    from repro_torch.configs import ServeConfig
    from repro_torch.serving import ContinuousEngine, Request
    cfg, params = _recurrent_params(cuda, name)
    P, G, B = 8, 16, 4
    serve = ServeConfig(max_batch=2, block_size=B, gen_length=G,
                        conf_threshold=0.5, scheduler="continuous",
                        fused_select=True, cache_layout=layout)
    prompts = np.random.default_rng(0).integers(2, cfg.vocab_size - 1,
                                                (5, P))
    caps = [None, B, None, 2 * B, None]
    runs = {}
    for graphs in (False, None):
        eng = ContinuousEngine(params, cfg, serve, prompt_len=P,
                               device=cuda, graphs=graphs)
        eng.warmup()
        outs, counts = _counted(lambda: eng.generate(
            [Request(prompt=p, id=i, max_tokens=c)
             for i, (p, c) in enumerate(zip(prompts, caps))]))
        calls = eng.call_counts()
        n_attn = _attention_layers(cfg)
        cached = n_attn * (calls["refine"] + calls["commit"])
        assert counts == [cached if layout == "dense" else 0,
                          cached if layout == "paged" else 0,
                          n_attn * calls["admit"], calls["refine"], 0, 0,
                          0, 0, 0] + [0] * 5
        runs[graphs] = ({o.id: (o.tokens.tolist(), o.steps, o.gen_length,
                                o.finish_reason) for o in outs},
                        calls, counts)
    assert runs[None] == runs[False]
    assert sorted(runs[None][0]) == list(range(5))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["jamba-v0.1-52b", "rwkv6-1.6b"])
@pytest.mark.parametrize("sampler", ["ar", "cdlm", "dual_cache"])
def test_recurrent_static_graph_equals_eager(cuda, name, sampler):
    """The static engine's graphs against its eager path with the state
    cache: ``ar`` commits the state at every step inside its graph,
    ``cdlm`` at each commit pass, ``dual_cache`` at each refresh."""
    import numpy as np

    from repro_torch.configs import ServeConfig
    from repro_torch.serving import Engine, Request
    cfg, params = _recurrent_params(cuda, name)
    serve = ServeConfig(max_batch=2, block_size=4, gen_length=16,
                        conf_threshold=0.5, cache_refresh_interval=2,
                        scheduler="static", sampler=sampler,
                        fused_select=True)
    prompts = np.random.default_rng(0).integers(2, cfg.vocab_size - 1,
                                                (3, 8))
    runs = {}
    for graphs in (False, None):
        eng = Engine(params, cfg, serve, prompt_len=8, device=cuda,
                     graphs=graphs)
        eng.warmup()
        outs, counts = _counted(lambda: eng.generate(
            [Request(prompt=p, id=i) for i, p in enumerate(prompts)]))
        runs[graphs] = ({o.id: (o.tokens.tolist(), o.steps, o.gen_length)
                         for o in outs}, eng.call_counts(), counts)
        assert (eng._graphs is not None) == (graphs is None)
    assert runs[None] == runs[False]


# the tuning registry's candidates (kernels/tuning.py): every knob the
# sweep tries launches and holds the plain version
def _limits():
    """chip_smoke.py's per-row select limits and gradient limit."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    return chip_smoke


@pytest.mark.cuda
@pytest.mark.parametrize("tiles", [1, 2, 4, 8])
@pytest.mark.parametrize("Kv,G,hd,Bq", [(2, 7, 64, 32), (4, 7, 128, 32),
                                        (32, 1, 128, 32), (2, 7, 64, 1)])
def test_every_decode_split_candidate_matches_plain(cuda, tiles, Kv, G, hd,
                                                    Bq):
    """Each split the sweep tries: the bf16 kernel against the plain
    version at 1e-4, and the paged kernel equal to the dense one bit for
    bit under the same split."""
    from repro_torch.kernels import tuning
    cfg = tuning.KernelConfig(tiles_per_split=tiles)
    assert cfg in tuning.candidates("decode_attn", Kv=Kv, rows=Bq * G)
    gen = torch.Generator(device=cuda).manual_seed(tiles * Kv + hd)
    lens = [0, 64 * tiles, 64 * tiles + 1, 300, 512]
    dense, paged = _decode_pair(cuda, gen, b=5, Bq=Bq, Kv=Kv, G=G, hd=hd,
                                S=512, lens=lens, dtype=torch.bfloat16,
                                page=32)
    kw = dict(scale=hd ** -0.5)
    got = decode_attention(*dense, **kw, config=cfg)
    torch.testing.assert_close(got, dref.decode_attention(*dense, **kw),
                               rtol=1e-4, atol=1e-4)
    assert torch.equal(paged_decode_attention(*paged, **kw, config=cfg), got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_every_select_chunk_candidate_matches_plain(cuda, dtype):
    from repro_torch.kernels import tuning
    cs = _limits()
    T, d, V = 256, 128, 20_011
    gen = torch.Generator(device=cuda).manual_seed(V)
    h = _randn(gen, T, d).to(dtype)
    w = (_randn(gen, V, d) * 0.1).to(dtype)
    masked = torch.rand((T,), generator=gen, device=cuda) < 0.7
    want_c, want_f = sref.select_streaming(h, w, masked)
    n_sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    cands = tuning.candidates("select", T=T, V=V, n_sms=n_sms, dtype=dtype)
    assert len(cands) >= 4
    for cfg in cands:
        cand, conf = fused_select(h, w, masked, config=cfg)
        conf_tol, gap_tol = cs.select_limits(torch, h, w, cand, V)
        logits = h.float() @ w.float().t()
        top2 = logits.topk(2, -1).values
        off = cand != want_c
        assert bool((top2[:, 0] - top2[:, 1])[off].lt(gap_tol[off]).all())
        same = masked & ~off
        rel = (conf - want_f).abs() / want_f.abs()
        assert bool((rel[same] <= conf_tol[same]).all()), cfg


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_every_xent_chunk_candidate_matches_plain(cuda, dtype):
    from repro_torch.kernels import tuning
    cs = _limits()
    T, d, V = 256, 128, 9000
    h, w, y, g = _xent_case(cuda, T, d, V, dtype, 11)
    want_loss, want_logz = xref.xent_streaming(h, w, y)
    want_dh, want_dw = xref.xent_backward(h, w, y, g, want_logz)
    n_sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    cands = tuning.candidates("xent", T=T, V=V, n_sms=n_sms, dtype=dtype)
    assert len({c.bwd_chunk for c in cands}) >= 2
    name = "bfloat16" if dtype == torch.bfloat16 else "float32"
    for cfg in cands:
        loss, logz = xops._forward(h, w, y, cfg)
        torch.testing.assert_close(loss, want_loss, rtol=0, atol=1e-4)
        dh, dw = xops._backward(h, w, y, logz, g, True, cfg)
        for got, want in ((dh, want_dh), (dw, want_dw)):
            ok, err = cs.grad_limit(torch, got, want, name)
            assert ok, (cfg, err)


@pytest.mark.cuda
def test_checked_in_table_entries_resolve_and_launch(cuda):
    """Each entry of the cuda table for this card: the wrappers, called
    without a config, resolve the entry's knobs at its shape and launch,
    and the kernel holds the plain version."""
    from repro_torch.kernels import tuning
    tuning.clear_cache()
    cs = _limits()
    here = tuning.backend(cuda)
    n_sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    entries = [e for k, e in tuning._load().items() if k[2] == here]
    for e in entries:
        cfg = tuning.KernelConfig.from_dict(e["config"])
        sh = e["shape"]
        gen = torch.Generator(device=cuda).manual_seed(7)
        if e["op"] == "decode_attn":
            Kv, G, hd, Bq = sh["Kv"], sh["G"], sh["hd"], sh["Bq"]
            assert tuning.resolve("decode_attn", backend_name=here, Kv=Kv,
                                  rows=Bq * G).tiles_per_split == \
                cfg.tiles_per_split
            dense, paged = _decode_pair(cuda, gen, b=4, Bq=Bq, Kv=Kv, G=G,
                                        hd=hd, S=512, lens=[0, 100, 300, 512],
                                        dtype=torch.bfloat16, page=32)
            before = decode_attention.launches
            got = decode_attention(*dense, scale=hd ** -0.5)
            assert decode_attention.launches == before + 1
            torch.testing.assert_close(got, dref.decode_attention(
                *dense, scale=hd ** -0.5), rtol=1e-4, atol=1e-4)
            assert torch.equal(paged_decode_attention(
                *paged, scale=hd ** -0.5), got)
        elif e["op"] == "select":
            T, V = sh["T"], sh["V"]
            assert tuning.resolve("select", backend_name=here, T=T, V=V,
                                  n_sms=n_sms, dtype=torch.bfloat16
                                  ).vocab_tiles_per_chunk == \
                cfg.vocab_tiles_per_chunk
            h = _randn(gen, T, sh["d"]).to(torch.bfloat16)
            w = (_randn(gen, V, sh["d"]) * 0.02).to(torch.bfloat16)
            m = torch.ones((T,), dtype=torch.bool, device=cuda)
            before = fused_select.launches
            cand, _ = fused_select(h, w, m)
            assert fused_select.launches == before + 1
            assert bool((cand >= 0).all() and (cand < V).all())
        else:
            # forward and backward without a config: the entry's knobs
            # through the wrappers' own resolution, against the plain
            # versions
            T, V = sh["T"], sh["V"]
            got = tuning.resolve("xent", backend_name=here, T=T, V=V,
                                 n_sms=n_sms, dtype=torch.bfloat16).to_dict()
            assert {k: got[k] for k in cfg.to_dict()} == cfg.to_dict()
            h, w, y, g = _xent_case(cuda, T, sh["d"], V, torch.bfloat16, 5,
                                    w_scale=0.02)
            before = (fused_xent.launches, fused_xent.backward_launches)
            loss, logz = xops._forward(h, w, y)
            dh, dw = xops._backward(h, w, y, logz, g, True)
            assert (fused_xent.launches, fused_xent.backward_launches) == \
                (before[0] + 1, before[1] + 1)
            want_loss, want_logz = xref.xent_streaming(h, w, y)
            torch.testing.assert_close(loss, want_loss, rtol=0, atol=1e-4)
            want_dh, want_dw = xref.xent_backward(h, w, y, g, want_logz)
            for name, got_g, want in (("dh", dh, want_dh),
                                      ("dw", dw, want_dw)):
                ok, err = cs.grad_limit(torch, got_g, want, "bfloat16")
                assert ok, (e["bucket"], name, err)


# ---------------------------------------------------------------------------
# the shapes of whisper-base and internvl2-1b (chip_smoke.py phase 10)
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("b,Kv,G,S,lens,window", [
    # whisper's decoder self attention: Kv 8, G 1 (32 folded rows)
    (8, 8, 1, 192, [128, 160] * 4, None),
    # internvl2 past its 8,192-token window: blocks at 8,448 and 8,480
    (4, 2, 7, 8512, [8448, 8480] * 2, 8192),
], ids=["whisper-base", "internvl2-1b window"])
def test_decode_attention_at_the_extras_configs(cuda, b, Kv, G, S, lens,
                                                window):
    gen = torch.Generator(device=cuda).manual_seed(S)
    Bq, hd, dtype = 32, 64, torch.bfloat16
    q = _randn(gen, b, Bq, Kv, G, hd).to(dtype)
    kc, vc = (_randn(gen, 2, b, S, Kv, hd)[1].to(dtype) for _ in range(2))
    kb, vb = (_randn(gen, b, Bq, Kv, hd).to(dtype) for _ in range(2))
    cl = torch.tensor(lens, dtype=torch.int32, device=cuda)
    kw = dict(scale=hd ** -0.5, window=window)
    got = decode_attention(q, kc, vc, kb, vb, cl, **kw)
    want = dref.decode_attention(q, kc, vc, kb, vb, cl, **kw)
    # both sides read the same inputs and accumulate in fp32
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("b,L,Kv,G,mode,P,window", [
    # whisper's encoder: 1,500 frames, ragged against the 64-key tile
    (2, 1500, 8, 1, "bidirectional", 0, None),
    # whisper's decoder prefill
    (2, 128, 8, 1, "block_causal", 128, None),
    # internvl2's long-window prefill: 256 prefix rows + P 8,192
    (1, 8448, 2, 7, "block_causal", 8448, None),
    (1, 8448, 2, 7, "block_causal", 8192, 8192),
], ids=["whisper encoder", "whisper prefill", "internvl2 L8448",
        "internvl2 L8448 window"])
def test_block_attention_at_the_extras_configs(cuda, b, L, Kv, G, mode, P,
                                               window):
    gen = torch.Generator(device=cuda).manual_seed(L + G)
    hd, dtype = 64, torch.bfloat16
    q = _randn(gen, b, L, Kv, G, hd).to(dtype)
    k, v = (_randn(gen, b, L, Kv, hd).to(dtype) for _ in range(2))
    kw = dict(mode=mode, prompt_len=P, block_size=32, window=window,
              scale=hd ** -0.5)
    got = flash_block_attention(q, k, v, **kw)
    want = bref.block_attention(q, k, v, **kw)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("d,V", [(512, 51_865), (896, 151_655)],
                         ids=["whisper-base", "internvl2-1b"])
def test_select_at_the_extras_configs(cuda, d, V):
    gen = torch.Generator(device=cuda).manual_seed(V)
    h = _randn(gen, 256, d).bfloat16()
    w = (_randn(gen, V, d) * 0.02).bfloat16()
    masked = torch.rand((256,), generator=gen, device=cuda) < 0.7
    cs = _limits()
    cand, conf = fused_select(h, w, masked)
    want_c, want_f = sref.select_streaming(h, w, masked)
    assert torch.equal(torch.isfinite(conf), masked)
    # chip_smoke.py's limits: a candidate may differ only at a top-2 gap
    # within the summation-order limit, confidences within theirs
    conf_tol, gap_tol = cs.select_limits(torch, h, w, cand, V)
    top2 = (h.float() @ w.float().t()).topk(2, -1).values
    off = cand != want_c
    assert bool((top2[:, 0] - top2[:, 1])[off].lt(gap_tol[off]).all())
    same = masked & ~off
    rel = (conf - want_f).abs() / want_f.abs()
    assert bool((rel[same] <= conf_tol[same]).all())


@pytest.mark.cuda
def test_xent_at_whisper_vocabulary(cuda):
    """phase 10d's DLM term: 128 rows over whisper's (51,865, 512) head."""
    h, w, y, g = _xent_case(cuda, 128, 512, 51_865, torch.bfloat16, 9, 0.3)
    hh, ww = h.clone().requires_grad_(), w.clone().requires_grad_()
    loss = fused_xent(hh, ww, y)
    dh, dw = torch.autograd.grad((loss * g).sum(), (hh, ww))
    want_loss, want_logz = xref.xent_streaming(h, w, y)
    want_dh, want_dw = xref.xent_backward(h, w, y, g, want_logz)
    torch.testing.assert_close(loss, want_loss, rtol=0, atol=1e-4)
    _grad_close(dh, want_dh, torch.bfloat16)
    _grad_close(dw, want_dw, torch.bfloat16)


SEQ_DECODE = """
from repro_torch.kernels.decode_attn import decode_attention
from repro_torch.parallel import make_sharded_decode_attention
dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
g = torch.Generator(device=dev).manual_seed(3)
b, Bq, Kv, G, hd, S = 4, 8, 2, 7, 64, 512
rnd = lambda *s: torch.randn(s, generator=g, device=dev).to(torch.bfloat16)
q, kc, vc = rnd(b, Bq, Kv, G, hd), rnd(b, S, Kv, hd), rnd(b, S, Kv, hd)
kb, vb = rnd(b, Bq, Kv, hd), rnd(b, Bq, Kv, hd)
lens = torch.tensor([512, 128, 127, 300], dtype=torch.int32, device=dev)
n = S // WORLD
fn = make_sharded_decode_attention(None, axis_size=WORLD, axis_rank=RANK)
got = {w: fn(q, kc[:, RANK * n:(RANK + 1) * n], vc[:, RANK * n:(RANK + 1) * n],
             kb, vb, lens, scale=hd ** -0.5, window=w) for w in (None, 64)}
if RANK == 0:
    for w, out in got.items():
        want = decode_attention(q, kc, vc, kb, vb, lens, scale=hd ** -0.5,
                                window=w)
        err = (out.float() - want).abs().max().item()
        tol = 1e-4 + want.abs().max().item() * 2 ** -8
        assert out.dtype == torch.bfloat16 and err <= tol, (w, err, tol)
print("SEQ_DECODE_OK")
"""


@pytest.mark.cuda
def test_sequence_parallel_decode_matches_the_kernel(cuda, tmp_path):
    """``chip_smoke.py`` phase 11a at a small size: four gloo ranks on the
    one card, each a quarter of the cache, the merged bf16 output against
    the decode kernel over the whole cache (its bf16 rounding plus 1e-4),
    without and with a window."""
    from _torch_dist import run_ranks
    outs = run_ranks(SEQ_DECODE, 4, tmp_path, timeout=300)
    assert all("SEQ_DECODE_OK" in o for o in outs)


# the forward's fused elementwise passes (kernels/elementwise)
ELEMENTWISE_CONFIGS = ("dream-7b", "llada-8b", "qwen2-0.5b", "gemma-7b")


def _elementwise_inputs(cuda, arch, rows):
    """Inputs of the three passes at ``arch``'s widths and ``rows`` token
    rows, laid out as the forward makes them: lanes of 32-row blocks at
    per-lane offsets up to ~770, or one prompt of 512 rows a lane."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    gen = torch.Generator(device=cuda).manual_seed(rows)
    L = 512 if rows > 1024 else 32
    b = rows // L
    d, hd = cfg.d_model, cfg.head_dim
    nq, nkv = cfg.n_heads * hd, cfg.n_kv_heads * hd

    def r(*shape, scale=1.0):
        return (_randn(gen, *shape) * scale).to(torch.bfloat16)
    bias = cfg.qkv_bias
    pos = (torch.arange(L, device=cuda) if L == 512 else
           torch.randint(0, 737, (b, 1), device=cuda, generator=gen)
           + torch.arange(L, device=cuda))
    return cfg, dict(
        x=r(b, L, d, scale=4.0), delta=r(b, L, d), w=r(d, scale=0.1) + 1,
        q=r(b, L, nq), k=r(b, L, nkv), v=r(b, L, nkv),
        bq=r(nq, scale=0.1) if bias else None,
        bk=r(nkv, scale=0.1) if bias else None,
        bv=r(nkv, scale=0.1) if bias else None, pos=pos,
        g=r(b, L, cfg.d_ff, scale=3.0), u=r(b, L, cfg.d_ff))


def _passes(fns, cfg, t):
    """The three passes of ``fns`` (the wrappers or ``ref``) on inputs
    ``t``: (x, h), (q, k, v), act(g) * u, and h without the add."""
    from repro_torch.kernels.elementwise import ElementwiseFns
    assert isinstance(fns, ElementwiseFns)
    return (fns.add_norm(t["x"], t["delta"], t["w"], cfg.norm_eps),
            fns.qkv_rope(t["q"], t["k"], t["v"], t["bq"], t["bk"], t["bv"],
                         t["pos"], head_dim=cfg.head_dim,
                         theta=cfg.rope_theta),
            fns.gated_act(t["g"], t["u"], cfg.activation),
            fns.add_norm(t["x"], None, t["w"], cfg.norm_eps)[1])


def _plain_fns():
    from repro_torch.kernels.elementwise import ElementwiseFns
    from repro_torch.kernels.elementwise import ref as eref
    return ElementwiseFns(eref.add_rmsnorm, eref.qkv_rope, eref.gated_act)


def _check_passes(got, want):
    """The residual sum, the QKV bias + RoPE and act(g) * u equal the plain
    path's bit for bit; the norm within one bf16 ulp: its fp32 sum of
    squares runs in another order than PyTorch's mean, so the mean may
    differ in its last bit, and a product on a rounding edge with it."""
    (gx, gh), gqkv, ga, gh0 = got
    (wx, wh), wqkv, wa, wh0 = want
    assert torch.equal(gx, wx)
    for g, w in zip(gqkv, wqkv):
        assert torch.equal(g, w)
    assert torch.equal(ga, wa)
    for g, w in ((gh, wh), (gh0, wh0)):
        ulps = _limits().bf16_ulps(torch, g, w)
        assert ulps.max().item() <= 1
        assert ulps.float().mean().item() < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [32, 1024, 16384])
@pytest.mark.parametrize("arch", ELEMENTWISE_CONFIGS)
def test_elementwise_kernels_match_plain(cuda, arch, rows):
    """Each pass against its plain version at the config's widths: the
    single lane's 32 rows, 32 lanes' 1,024, an admission's 16,384."""
    from repro_torch.kernels.elementwise import ElementwiseFns
    cfg, t = _elementwise_inputs(cuda, arch, rows)
    fns = ElementwiseFns()[:3]      # the passes (not the grouped MoE)
    before = [f.launches for f in fns]
    with torch.no_grad():
        got = _passes(ElementwiseFns(), cfg, t)
        want = _passes(_plain_fns(), cfg, t)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(fns, before)] == [2, 1, 1]
    _check_passes(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ELEMENTWISE_CONFIGS)
def test_elementwise_kernels_in_a_cuda_graph(cuda, arch):
    """The three passes captured in a CUDA graph: each replay equals the
    eager kernels bit for bit and the plain versions as above, and counts
    its launches."""
    from repro_torch.graphs import Graph
    from repro_torch.kernels.elementwise import ElementwiseFns
    cfg, t = _elementwise_inputs(cuda, arch, 1024)
    fns = ElementwiseFns()
    with torch.no_grad():
        eager = _passes(fns, cfg, t)
        graph = Graph(lambda: _passes(fns, cfg, t))
        before = [f.launches for f in fns[:3]]
        for _ in range(2):
            out = graph.replay()
        torch.cuda.synchronize()
        assert [f.launches - b for f, b in zip(fns[:3], before)] == [4, 2, 2]
        flat = lambda o: [o[0][0], o[0][1], *o[1], o[2], o[3]]  # noqa: E731
        for g, e in zip(flat(out), flat(eager)):
            assert torch.equal(g, e)
        _check_passes(out, _passes(_plain_fns(), cfg, t))


def _dream_shaped(cuda, n_layers=2):
    """dream-7b at its widths, ``n_layers`` layers, a small vocabulary; bf16
    params with a sharp (untied) head: >1 token an iteration, and no choice
    near a tie."""
    from repro_torch.bridge import init_params
    from repro_torch.configs import get_config
    cfg = get_config("dream-7b").reduced(
        dtype="bfloat16", n_layers=n_layers, d_model=3584, n_heads=28,
        n_kv_heads=4, head_dim=128, d_ff=18944)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         cuda, torch.bfloat16)
    with torch.no_grad():
        params["embed"]["head"] *= 40.0
        params["embed"]["head"][cfg.mask_token_id] = 0
    return cfg, params


@pytest.mark.cuda
def test_cached_forward_routes_through_the_elementwise_kernels(cuda):
    """One cached dream-shaped block forward through ``KERNELS``: per layer
    two add + norms, one QKV bias + RoPE and one gated activation, and the
    final norm; the same forward through ``PLAIN`` launches none and gives
    hidden states within the passes' limits' worth of each other."""
    from repro_torch.core import cache as C
    from repro_torch.core.block_loop import (
        KERNELS,
        PLAIN,
        SamplerSpec,
        lane_block_forward,
    )
    from repro_torch.kernels.elementwise import ElementwiseFns
    cfg, params = _dream_shaped(cuda)
    spec = SamplerSpec(prompt_len=64, gen_len=64, block_size=32)
    cache = C.init_cache(cfg, 4, 128, device=cuda)
    tokens = torch.randint(2, cfg.vocab_size - 1, (4, 128), device=cuda,
                           generator=torch.Generator(device=cuda)
                           .manual_seed(1))
    starts = torch.tensor([64, 64, 96, 64], device=cuda)
    fns = ElementwiseFns()[:3]      # the passes (not the grouped MoE)
    out = {}
    for bundle in (KERNELS, PLAIN):
        before = [f.launches for f in fns]
        with torch.no_grad():
            out[bundle] = lane_block_forward(
                params, tokens, starts, cache, cfg=cfg, spec=spec,
                return_hidden=True, elementwise_fns=bundle.elementwise,
                moe_per_row=True)[0]
        torch.cuda.synchronize()
        n = cfg.n_layers
        want = [2 * n + 1, n, n] if bundle is KERNELS else [0, 0, 0]
        assert [f.launches - b for f, b in zip(fns, before)] == want
    diff = (out[KERNELS].float() - out[PLAIN].float()).abs().max().item()
    assert diff <= 0.05 * out[PLAIN].float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_continuous_engine_kernels_equal_plain(cuda, layout, monkeypatch):
    """A small ``ContinuousEngine`` decode (bf16, through its CUDA graphs)
    with ``KERNELS``' elementwise passes and with ``PLAIN``'s (None: the
    plain ops) in every forward, the admission's and the block forwards':
    the same tokens, steps and call counts; the plain run launches no pass.
    Both runs keep the attention kernels: at bf16 the kernel and the plain
    attention round differently enough to flip choices near a tie, which
    no change of the passes' makes (the norm's at most one bf16 ulp in a
    few elements)."""
    import numpy as np

    from repro_torch.configs import ServeConfig
    from repro_torch.core.block_loop import PLAIN, lane_block_forward
    from repro_torch.models import forward
    from repro_torch.serving import ContinuousEngine, Request
    from repro_torch.serving import engine as E
    cfg, params = _dream_shaped(cuda)
    P, G, B = 32, 64, 32
    serve = ServeConfig(max_batch=2, block_size=B, gen_length=G,
                        conf_threshold=0.5, scheduler="continuous",
                        fused_select=True, cache_layout=layout)
    prompts = np.random.default_rng(0).integers(2, cfg.vocab_size - 1,
                                                (4, P))

    def plain(fn):
        # the engine passes its own bundle (it carries the grouped MoE's
        # tally): the plain run replaces it in every call
        def call(*a, **kw):
            kw.update(elementwise_fns=PLAIN.elementwise)
            return fn(*a, **kw)
        return call

    runs = {}
    for name in ("kernels", "plain"):
        if name == "plain":
            monkeypatch.setattr(E, "forward", plain(forward))
            monkeypatch.setattr(E, "lane_block_forward",
                                plain(lane_block_forward))
        eng = ContinuousEngine(params, cfg, serve, prompt_len=P, device=cuda)
        eng.warmup()
        outs, counts = _counted(lambda: eng.generate(
            [Request(prompt=p, id=i) for i, p in enumerate(prompts)]))
        runs[name] = ({o.id: (o.tokens.tolist(), o.steps) for o in outs},
                      eng.call_counts(), counts)
    assert runs["kernels"][:2] == runs["plain"][:2]
    assert runs["kernels"][2][:6] == runs["plain"][2][:6]
    # COUNTERS [6:9]: the elementwise passes; [9:]: the grouped MoE's five
    # (no MoE)
    assert runs["plain"][2][6:] == [0, 0, 0] + [0] * 5
    calls = runs["kernels"][1]
    forwards = calls["admit"] + calls["refine"] + calls["commit"]
    n = cfg.n_layers
    assert runs["kernels"][2][6:] == [forwards * (2 * n + 1), forwards * n,
                                      forwards * n] + [0] * 5


# sdar-30b-a3b: qkv_rope's QK-norm instance and the grouped MoE (kernels/moe)
@pytest.mark.cuda
@pytest.mark.parametrize("rows", [32, 1024])
def test_qkv_rope_qk_norm_kernel_matches_plain(cuda, rows):
    """The QK-norm instance at sdar-30b-a3b's widths against the plain
    version (``chip_smoke.check_qk_norm``: v bit for bit, q and k within
    two bf16 ulps of their largest value), one launch a call."""
    from repro_torch.kernels.elementwise import qkv_rope
    before = qkv_rope.launches
    _limits().check_qk_norm(torch, cuda, rows=rows)
    assert qkv_rope.launches == before + 1


MOE_CASES = [(64, 4, 2, 256, 256), (300, 16, 4, 256, 128),
             (1024, 128, 8, 2048, 768)]


@pytest.mark.cuda
@pytest.mark.parametrize("T,E,k,d,f", MOE_CASES)
def test_grouped_moe_kernels_match_plain(cuda, T, E, k, d, f):
    """The five ``moe_*`` kernels against the plain version
    (``chip_smoke.check_moe``: the layout's counts and tiles equal, the
    output within ``MOE_REL`` of max|y|), each launched once a call."""
    from repro_torch.graphs import COUNTERS
    from repro_torch.kernels import moe
    names = ("moe_align", "moe_gather", "moe_gate_up", "moe_down",
             "moe_combine")
    fns = [getattr(moe, n) for n in names]
    assert all((fn, "launches") in COUNTERS for fn in fns)
    before = [fn.launches for fn in fns]
    _limits().check_moe(torch, cuda, T=T, E=E, k=k, d=d, f=f)
    # check_moe calls moe_align once on its own, then the whole product
    assert [fn.launches - b for fn, b in zip(fns, before)] == [2, 1, 1, 1, 1]


@pytest.mark.cuda
def test_grouped_moe_in_a_cuda_graph_counts_into_the_tally(cuda):
    """The grouped product captured in a CUDA graph: each replay equals the
    eager call bit for bit, adds its launches, and adds the pairs of each
    expert and the padded rows into the device-side tally."""
    from repro_torch.graphs import Graph
    from repro_torch.kernels.moe import grouped_experts, moe_gate_up
    from repro_torch.kernels.moe import ref as mref
    T, E, k = 512, 16, 4
    x, gates, ids, w = _limits().moe_inputs(torch, cuda, T=T, E=E, k=k,
                                            d=256, f=128)
    tally = torch.zeros(E + 1, dtype=torch.int64, device=cuda)
    args = (x, gates, ids, w["wi_gate"], w["wi_up"], w["wo"])
    with torch.no_grad():
        eager = grouped_experts(*args)
        graph = Graph(lambda: grouped_experts(*args, tally=tally))
        tally.zero_()
        before = moe_gate_up.launches
        for _ in range(3):
            out = graph.replay()
        torch.cuda.synchronize()
    assert torch.equal(out, eager)
    assert moe_gate_up.launches == before + 3
    counts = torch.bincount(ids.reshape(-1), minlength=E)
    assert torch.equal(tally[:E], 3 * counts)
    assert tally[E].item() == 3 * int(
        ((counts + mref.BM - 1) // mref.BM * mref.BM).sum())


@pytest.mark.cuda
def test_sdar_engine_through_the_grouped_kernels(cuda):
    """sdar-30b-a3b at two layers of its published widths (bf16) through
    ``ContinuousEngine``'s graphs, paged: each forward launches the five
    ``moe_*`` kernels once a layer and the QK-norm ``qkv_rope`` once a
    layer; the tally counts every pair; tokens equal an eager engine's."""
    import numpy as np

    from repro_torch.bridge import init_params
    from repro_torch.configs import ServeConfig, get_config
    from repro_torch.serving import ContinuousEngine, Request
    cfg = get_config("sdar-30b-a3b").reduced(
        dtype="bfloat16", n_layers=2, d_model=2048, n_heads=32,
        n_kv_heads=4, head_dim=128, n_experts=128, experts_per_token=8,
        moe_d_ff=768)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         cuda, torch.bfloat16)
    serve = ServeConfig(max_batch=4, block_size=32, gen_length=64,
                        scheduler="continuous", cache_layout="paged",
                        fused_select=True)
    prompts = np.random.default_rng(0).integers(2, 500, (5, 64))
    runs = {}
    for graphs in (False, None):
        eng = ContinuousEngine(params, cfg, serve, 64, device=cuda,
                               graphs=graphs)
        eng.warmup()
        outs, counts = _counted(lambda: eng.generate(
            [Request(prompt=p, id=i) for i, p in enumerate(prompts)]))
        calls, stats = eng.call_counts(), eng.moe_stats()
        forwards = calls["admit"] + calls["refine"] + calls["commit"]
        # COUNTERS: ..., qkv_rope (7), gated_act (8), the moe_* five (9-13)
        assert counts[7] == cfg.n_layers * forwards and counts[8] == 0
        assert counts[9:] == [cfg.n_layers * forwards] * 5
        tokens = 4 * (64 * calls["admit"]
                      + 32 * (calls["refine"] + calls["commit"]))
        assert stats["pairs_total"] == tokens * cfg.n_layers * 8
        runs[graphs] = {o.id: o.tokens.tolist() for o in outs}
    assert runs[False] == runs[None] and sorted(runs[None]) == list(range(5))
