"""The reduction of a device trace, on a trace made by hand: kernel
groups, the union of busy intervals, idle gaps named by the host op open
across them, and clipping to the harness's step ranges."""
import pytest

import rehearsal as R

R.paths()
from harness import trace as TR  # noqa: E402


def make():
    kernels = [("sm90_xmma_gemm_bf16", 100, 200),
               ("decode_attn_tc<128,dense>", 150, 250),   # overlaps the gemm
               ("select_partial_tc", 300, 350),
               ("void at::native::elementwise_kernel<int>", 400, 420),
               ("Memcpy DtoD (Device -> Device)", 420, 430),
               ("block_attn_tc<128>", 950, 1100)]          # past the span
    ranges = [(50, 500), (500, 1000)]
    host = [("bench.step", 50, 500), ("cudaStreamSynchronize", 430, 490),
            ("aten::_local_scalar_dense", 425, 495)]
    return TR.Trace(kernels=kernels, ranges=ranges, host_ops=host)


def test_groups_and_busy():
    tr = make()
    g = tr.group_seconds()
    assert g["matmul"] == pytest.approx(100e-9)
    assert g["decode_attention"] == pytest.approx(100e-9)
    assert g["select"] == pytest.approx(50e-9)
    assert g["other"] == pytest.approx(20e-9)
    assert g["memcpy"] == pytest.approx(10e-9)
    assert g["block_attention"] == pytest.approx(50e-9)   # clipped at 1000
    assert tr.n_kernels() == 5
    # [100, 250], [300, 350], [400, 430], [950, 1000]
    assert tr.busy_s() == pytest.approx((150 + 50 + 30 + 50) * 1e-9)
    assert tr.window_s() == pytest.approx(950e-9)


def test_idle_gaps_are_named_by_the_innermost_host_op():
    gaps = make().idle_gaps()
    assert gaps[0] == ["bench.step/bench.step", pytest.approx(520e-9)]
    named = {round(s * 1e9): n for n, s in gaps}
    assert named[50] == "bench.step/bench.step"      # [250, 300]
    assert named[520] == "bench.step/bench.step"     # [430, 950]
    assert sum(s for _, s in gaps) == pytest.approx(
        make().window_s() - make().busy_s())


def test_top_ops_by_group():
    top = make().top_ops()
    assert [g for g, _ in top][:2] in (["matmul", "decode_attention"],
                                       ["decode_attention", "matmul"])
