"""jamba (Mamba, attention and MoE slots at 7:1 and every other slot)
decoded through ``run_block_loop``, the port against the JAX package's
samplers on the CPU, from the same numpy params and prompts at
``ModelConfig.reduced()`` fp32 (``tests/_torch_recurrent.py``): the
decoders without a block cache, greedy through the fused select
(``vanilla`` and ``fast_dllm`` recompute the canvas with no cache, ``ar``
commits the Mamba state at every token), and ``cdlm`` sampled at 0.7.
The block-cache decoders are ``test_torch_jamba_decode_cached.py``'s (the
split keeps each file near two minutes: the reference compiles jamba
slowly). Tokens, steps, calls and generation lengths exactly."""
import pytest

torch = pytest.importorskip("torch")

import _torch_recurrent as RC  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jamba():
    return RC.setup("jamba-v0.1-52b")


@pytest.mark.parametrize("name", ["vanilla", "fast_dllm", "ar"])
def test_greedy_decoder_matches_jax(jamba, name):
    RC.check_decoder(jamba, name)


def test_sampled_cdlm_matches_jax(jamba):
    RC.check_sampled_cdlm(jamba)
