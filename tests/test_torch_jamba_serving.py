"""jamba through the static ``Engine``, the port against the JAX
package's engine on the CPU, from the same numpy params and requests at
``ModelConfig.reduced()`` fp32 (``tests/_torch_recurrent.py``): five
requests of mixed ``max_tokens`` through two lanes (three batches, the
last padded), greedy through the fused select, for ``vanilla``,
``fast_dllm`` and ``ar`` (the block-cache decoders:
``test_torch_jamba_serving_cached.py``). Tokens, steps, generation lengths
and finish reasons exactly; the engine's call count is its batches'
``run_block_loop`` calls (which ``test_torch_jamba_decode*.py`` hold to
the reference's). Also the engine's decode state: every Mamba state leaf
of a batch's cache is rewritten for the next batch, so a batch decodes as
a fresh engine does."""
import pytest

torch = pytest.importorskip("torch")

import _torch_recurrent as RC  # noqa: E402
from repro_torch.configs import ServeConfig  # noqa: E402
from repro_torch.serving import Engine, Request  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jamba():
    return RC.setup("jamba-v0.1-52b")


@pytest.mark.parametrize("name", ["vanilla", "fast_dllm", "ar"])
def test_static_engine_matches_jax(jamba, name):
    RC.check_static_engine(jamba, name)


def test_state_leaves_are_reloaded_between_batches(jamba):
    """The engine keeps one decode state for its life: after a batch, every
    leaf of its cache (the Mamba slots' ``conv`` and ``ssm`` too) is
    rewritten at the next load, at the same address, and the next batch
    decodes as a fresh engine's."""
    serve = RC.serve(ServeConfig, sampler="cdlm", fused_select=True)
    eng = Engine(jamba.params, jamba.cfg, serve, prompt_len=RC.P,
                 device="cpu")
    reqs = RC.trace(jamba.cfg, Request, n=4)
    eng.generate(reqs[:2])
    leaves = {id(b): b for b in eng._state.cache_buffers()}
    kinds = {k for slot in eng._state.cache for k in slot}
    assert kinds == {"conv", "ssm", "k", "v"}
    assert any(float(b.abs().max()) > 0 for b in leaves.values())
    later = eng.generate(reqs[2:])
    assert {id(b) for b in eng._state.cache_buffers()} == set(leaves)
    fresh = Engine(jamba.params, jamba.cfg, serve, prompt_len=RC.P,
                   device="cpu").generate(reqs[2:])
    RC.same_outputs(later, fresh)
