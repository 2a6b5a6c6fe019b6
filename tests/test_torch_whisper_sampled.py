"""whisper-base's top-1 (``vanilla``) and exact-cache (``cdlm``) decoders
sampled at 0.7 through the port's ``run_block_loop`` against the JAX
samplers, with frame embeddings, at ``reduced()`` fp32
(``_torch_extras.py``): the reference's threefry streams, drawn over its
canvas-shaped logits. Tokens, steps, calls and generation lengths
exactly."""
import pytest

torch = pytest.importorskip("torch")

from _torch_extras import WHISPER, check_decoder, setup  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def s():
    return setup(WHISPER)


@pytest.mark.parametrize("name", ["vanilla", "cdlm"])
def test_sampled(s, name):
    check_decoder(s, name, temperature=0.7)
