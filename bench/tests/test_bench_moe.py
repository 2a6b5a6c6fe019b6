"""The MoE cell's counts (``counts/moe``, ``counts/moe_step``) against
arithmetic done by hand at small shapes, and its readers (``moe_roofline``,
``moe_share``, ``moe_step_mfu``) on a window and a trace made by hand."""
import types

import pytest

import rehearsal as R

R.paths()
from harness import cell as CL  # noqa: E402
from harness import peaks  # noqa: E402
from harness import spec as SP  # noqa: E402
from harness import trace as TR  # noqa: E402
from harness import window as WD  # noqa: E402

M = {"n_layers": 2, "d_model": 8, "n_heads": 4, "n_kv_heads": 2,
     "head_dim": 2, "d_ff": 16, "vocab_size": 10, "moe_d_ff": 4,
     "n_experts": 4, "experts_per_token": 2}


def count(name):
    return SP.load_module(R.REPO, "counts", name)


def reader(name):
    return SP.load_module(R.REPO, "metrics", name)


def test_moe_call():
    # 3 tokens, 6 pairs over 4 experts: 4 (1 - (3/4)^6) experts hit
    hit = 4 * (1 - 0.75 ** 6)
    assert count("moe").experts_hit(4, 6) == pytest.approx(hit)
    flops, nbytes = count("moe").call(M, 3)
    assert flops == 2 * 3 * 6 * 8 * 4
    assert nbytes == pytest.approx(2 * (3 * hit * 8 * 4 + 2 * 3 * 8))
    # at a decode batch's pairs every expert is read
    assert count("moe").experts_hit(128, 32768) == pytest.approx(128)


def test_moe_step():
    moe, dec, blk, sel, step = (count(n) for n in (
        "moe", "decode_attn", "block_attn", "select", "moe_step"))
    layer = lambda rows: (2 * rows * 8 * (2 * 8 + 2 * 4)  # noqa: E731
                          + 2 * rows * 8 * 4 + moe.call(M, rows)[0])
    assert step.layer_flops(M, 4) == layer(4)
    got = step.step_flops(M, block=2, prompt_len=5, cache_lens=[5, 7],
                          admitted=1, iters=3, fused_select=True)
    fwd = 2 * (layer(4) + dec.call(M, 2, [5, 7])[0])
    want = (3 * (fwd + sel.call(M, 4)[0]) + fwd
            + 2 * (layer(5) + blk.call(M, 5, 1)[0]))
    assert got == want
    dense = step.step_flops(M, block=2, prompt_len=5, cache_lens=[5, 7],
                            admitted=0, iters=1, fused_select=False)
    assert dense == 2 * fwd + 2 * 4 * 8 * 10


def _ctx(trace, steps):
    cell = types.SimpleNamespace(
        root=R.REPO, config={"model": M},
        mix={"engine": {"block_size": 2, "fused_select": True},
             "prompt_len": 5})
    win = WD.Window(steps=steps)
    return CL.Context(cell, win, trace)


def _trace():
    kernels = [("moe_align(long const*, int)", 100, 110),
               ("moe_gate_up(CUtensorMap_st)", 110, 300),
               ("moe_down(CUtensorMap_st)", 300, 400),
               ("sm90_xmma_gemm_bf16", 400, 500),
               ("Memcpy DtoD (Device -> Device)", 500, 600)]
    return TR.Trace(kernels=kernels, ranges=[(0, 1000)], host_ops=[])


def test_moe_share_and_roofline():
    steps = [WD.Step(0.0, 1.0, 0, 3, [(0, 0, [1, 2]), (1, 3, [3, 4])],
                     traced=True)]
    ctx = _ctx(_trace(), steps)
    # moe 300 ns of 400 ns of kernels (the copy left out)
    assert reader("moe_share").read(ctx) == pytest.approx(75.0)
    moe = count("moe")
    want = 2 * (4 * peaks.bound_s(*moe.call(M, 4))      # 3 iters + commit
                + peaks.bound_s(*moe.call(M, 5)))        # one admitted
    assert reader("moe_roofline").read(ctx) == pytest.approx(
        100 * want / 300e-9)


def test_moe_readers_find_nothing_without_moe_kernels():
    tr = TR.Trace(kernels=[("sm90_xmma_gemm_bf16", 0, 10)],
                  ranges=[(0, 100)], host_ops=[])
    ctx = _ctx(tr, [WD.Step(0.0, 1.0, 0, 1, [(0, 1, [1, 2])], traced=True)])
    assert reader("moe_share").read(ctx) is None
    assert reader("moe_roofline").read(ctx) is None
    assert reader("moe_step_mfu").read(_ctx(None, [])) is None


def test_moe_step_mfu_leaves_out_the_traced_steps():
    steps = [WD.Step(0.0, 2.0, 0, 3, [(0, 0, [1, 2])], traced=False),
             WD.Step(2.0, 9.0, 3, 6, [(0, 1, [1, 2])], traced=True)]
    ctx = _ctx(_trace(), steps)
    flops = count("moe_step").step_flops(
        M, block=2, prompt_len=5, cache_lens=[5], admitted=1, iters=3,
        fused_select=True)
    assert reader("moe_step_mfu").read(ctx) == pytest.approx(
        100 * flops / (2.0 * peaks.H100["bf16_flops"]))
