"""The counts against arithmetic done by hand at small shapes."""
import pytest

import rehearsal as R

R.paths()
from harness import peaks  # noqa: E402
from harness import spec as SP  # noqa: E402

M = {"n_layers": 2, "d_model": 8, "n_heads": 4, "n_kv_heads": 2,
     "head_dim": 2, "d_ff": 16, "vocab_size": 10}


def count(name):
    return SP.load_module(R.REPO, "counts", name)


def test_block_attention():
    # 3 prompts of 5: 4 * 25 pairs * 4 heads * hd 2 each; q, o 4 heads and
    # k, v 2 heads of 5 rows, bf16
    assert count("block_attn").call(M, 5, 3) == (3 * 4 * 25 * 4 * 2,
                                                 2 * 3 * 5 * 2 * (8 + 4))


def test_decode_attention():
    # lanes at cache lengths 6 and 10, block 2
    flops, nbytes = count("decode_attn").call(M, 2, [6, 10])
    assert flops == 4 * 2 * 8 * 4 * 2 + 4 * 2 * 12 * 4 * 2
    per = lambda S: 2 * 2 * (2 * S * 2 + 2 * 2 * 2 + 2 * 2 * 4)  # noqa: E731
    assert nbytes == per(6) + per(10)


def test_select():
    assert count("select").call(M, 3) == (2 * 3 * 8 * 10,
                                          2 * (10 * 8 + 3 * 8) + 3 * 9)


def test_matmul():
    gemms = count("matmul").gemms(M, rows=3, head_rows=2)
    # 7 products, each over 2 layers, then the head
    assert len(gemms) == 15
    assert gemms[0] == gemms[1] == (2 * 3 * 8 * 8, 2 * (64 + 24 + 24))  # wq
    assert gemms[10] == (2 * 3 * 8 * 16, 2 * (128 + 24 + 48))  # wi_up
    assert gemms[-1] == (2 * 2 * 8 * 10, 2 * (80 + 16) + 4 * 20)


def test_model_step():
    mm, dec, blk, sel = (count(n) for n in ("matmul", "decode_attn",
                                            "block_attn", "select"))
    got = count("model_step").step_flops(
        M, block=2, prompt_len=5, cache_lens=[5, 7], admitted=1, iters=3,
        fused_select=True)
    fwd = mm.forward_flops(M, 4) + 2 * dec.call(M, 2, [5, 7])[0]
    want = (3 * (fwd + sel.call(M, 4)[0]) + fwd
            + mm.forward_flops(M, 5) + 2 * blk.call(M, 5, 1)[0])
    assert got == want


@pytest.mark.parametrize("flops,nbytes,want", [
    (989e12, 0, 1.0), (0, 3.35e12, 1.0), (989e12, 6.7e12, 2.0)])
def test_bound_is_the_larger_term(flops, nbytes, want):
    assert peaks.bound_s(flops, nbytes) == pytest.approx(want)
