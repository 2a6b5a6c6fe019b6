"""jamba decoded through ``run_block_loop`` by the decoders with a block
cache, the port against the JAX package's samplers on the CPU, from the
same numpy params and prompts at ``ModelConfig.reduced()`` fp32
(``tests/_torch_recurrent.py``), greedy through the fused select: the
approx policies' refresh replaces the Mamba state with the whole canvas's
(stale future blocks included, as the reference's), and ``cdlm``'s commit
pass with the finalized block's, on the dense and the paged cache. Tokens,
steps, calls and generation lengths exactly."""
import pytest

torch = pytest.importorskip("torch")

import _torch_recurrent as RC  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jamba():
    return RC.setup("jamba-v0.1-52b")


@pytest.mark.parametrize("name", ["dual_cache", "interval_cache", "cdlm"])
def test_greedy_decoder_matches_jax(jamba, name):
    RC.check_decoder(jamba, name, ("dense", "paged") if name == "cdlm"
                     else ("dense",))
