"""The port's CUDA kernels against their plain PyTorch versions, on a CUDA
device (skipped elsewhere: a CUDA kernel has no CPU mode). Imports nothing
of JAX, so it runs on a machine without it:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.decode_attn import decode_attention  # noqa: E402
from repro_torch.kernels.decode_attn import ref as dref  # noqa: E402
from repro_torch.kernels.select import fused_select  # noqa: E402
from repro_torch.kernels.select import ref as sref  # noqa: E402


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
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q = torch.zeros((1, 4, 1, 1, 96), device=cuda)        # head_dim 96
    kv = torch.zeros((1, 8, 1, 96), device=cuda)
    blk = torch.zeros((1, 4, 1, 96), device=cuda)
    lens = torch.zeros((1,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        decode_attention(q, kv, kv, blk, blk, lens)
    h = torch.zeros((4, 12), device=cuda)                   # d % 8 != 0
    with pytest.raises(ValueError, match="multiple of 8"):
        fused_select(h, torch.zeros((10, 12), device=cuda),
                     torch.ones((4,), dtype=torch.bool, device=cuda))
