"""jamba through the static ``Engine`` with the decoders that keep a
block cache (``dual_cache``, ``interval_cache``, ``cdlm`` on the dense and
the paged cache), the port against the JAX package's engine on the CPU,
as ``test_torch_jamba_serving.py`` holds the others: tokens, steps,
generation lengths and finish reasons exactly, and the engine's call
count its batches' ``run_block_loop`` calls."""
import pytest

torch = pytest.importorskip("torch")

import _torch_recurrent as RC  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jamba():
    return RC.setup("jamba-v0.1-52b")


@pytest.mark.parametrize("name", ["dual_cache", "interval_cache", "cdlm"])
def test_static_engine_matches_jax(jamba, name):
    RC.check_static_engine(jamba, name, ("dense", "paged") if name == "cdlm"
                           else ("dense",))
