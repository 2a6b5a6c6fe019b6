"""The port's arithmetic-intensity model (``repro_torch/roofline``) and
hardware configs against the JAX package's: the same formulas give the same
numbers (rel 1e-12), and the port's H100 has its data sheet's ridge."""
import dataclasses

import pytest

pytest.importorskip("torch")

from repro.configs import base as jax_base  # noqa: E402
from repro.roofline import ai_model as jax_ai  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch import roofline as ai  # noqa: E402

REL = 1e-12


def test_paper_table_equals_jax():
    got, want = ai.paper_table(), jax_ai.paper_table()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            assert g[k] == pytest.approx(w[k], rel=REL), (g["batch"], k)
    assert ai.PAPER_TARGETS == jax_ai.PAPER_TARGETS


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("block", [4, 16, 32])
def test_blockwise_ai_equals_jax(fused, block):
    for bs in (1, 8, 128):
        for m, jm in ((ai.LLADA_8B, jax_ai.LLADA_8B),
                      (ai.LLAMA31_8B, jax_ai.LLAMA31_8B)):
            assert ai.blockwise_dlm_ai(m, bs, block, fused_select=fused) == \
                pytest.approx(jax_ai.blockwise_dlm_ai(
                    jm, bs, block, fused_select=fused), rel=REL)
    cost = ai.step_cost(ai.LLADA_8B, q_tokens=block, ctx_tokens=640,
                        batch=8, fused_select=fused)
    want = jax_ai.step_cost(jax_ai.LLADA_8B, q_tokens=block, ctx_tokens=640,
                            batch=8, fused_select=fused)
    assert cost == pytest.approx(want, rel=REL)


def test_model_configs_equal_jax():
    for name in ("LLADA_8B", "LLAMA31_8B"):
        assert dataclasses.asdict(getattr(ai, name)) == \
            dataclasses.asdict(getattr(jax_ai, name))
        assert ai.param_bytes(getattr(ai, name)) == \
            jax_ai.param_bytes(getattr(jax_ai, name))


def test_attainable_tflops_equals_jax_on_the_a100():
    assert dataclasses.asdict(configs.A100) == \
        dataclasses.asdict(jax_base.A100)
    for x in (0.5, 1.0, 27.7, 153.0, 295.0, 486.5, 1e4):
        assert ai.attainable_tflops(x) == pytest.approx(
            jax_ai.attainable_tflops(x), rel=REL)
        assert ai.attainable_tflops(x, configs.A100) == pytest.approx(
            jax_ai.attainable_tflops(x, jax_base.A100), rel=REL)


def test_h100_is_the_port_s_card():
    h = configs.H100
    assert h.name == "h100-sxm5-80g"
    assert (h.peak_flops, h.hbm_bw, h.hbm_bytes) == (989e12, 3.35e12, 80e9)
    assert h.ridge_ai == pytest.approx(295.2, abs=0.05)
    assert ai.attainable_tflops(1.0, h) == pytest.approx(3.35)
    assert ai.attainable_tflops(1e4, h) == pytest.approx(989.0)
    # no default card: every field is given
    with pytest.raises(TypeError):
        configs.HardwareConfig()
