"""whisper-base's six decoders through the port's ``run_block_loop``
against the JAX samplers, with frame embeddings, at ``reduced()`` fp32
(3 encoder layers, 2 decoder layers; ``_torch_extras.py``): greedy
through the fused select. Tokens, steps, calls and generation lengths
exactly.
``cdlm`` and ``ar`` prefill the cross cache once and read it in every
block forward; ``vanilla`` and ``fast_dllm`` run the encoder in every
forward; the approx decoders in every refresh. The sampled cases:
``tests/test_torch_whisper_sampled.py``."""
import pytest

torch = pytest.importorskip("torch")

from _torch_extras import WHISPER, check_decoder, setup  # noqa: E402
from _torch_recurrent import DECODERS  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def s():
    return setup(WHISPER)


@pytest.mark.parametrize("name", DECODERS)
def test_greedy(s, name):
    check_decoder(s, name)
