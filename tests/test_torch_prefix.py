"""internvl2-1b's prefix embeddings in the port against the JAX package,
at ``reduced()`` fp32 (8 prefix rows, ``_torch_extras.py``): the forward
with ``prefix_embeds`` in the three mask modes and the per-lane cached
block forward at ``pos_offset`` past each lane's canvas start, within
1e-4; the six decoders through ``run_block_loop`` (greedy through the
fused select; ``cdlm`` also sampled), tokens, steps, calls and generation
lengths exactly, ``cdlm`` on the dense and the paged layout (so paged ==
dense)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_extras import INTERNVL, check_decoder, extras, setup  # noqa: E402
from _torch_recurrent import DECODERS  # noqa: E402
from repro.core import block_loop as JB  # noqa: E402
from repro.core import cache as JC  # noqa: E402
from repro.models import forward as jax_forward  # noqa: E402
from repro_torch.core import block_loop as TB  # noqa: E402
from repro_torch.core import cache as C  # noqa: E402
from repro_torch.core import masks  # noqa: E402
from repro_torch.kernels.block_attn import flash_block_attention  # noqa: E402
from repro_torch.models import forward  # noqa: E402

torch.set_num_threads(2)

STACK_TOL = 1e-4      # the whole stack, fp32
b, P, B = 2, 8, 4


@pytest.fixture(scope="module")
def plain():
    # the JAX init's head as it is, for the forward's logits
    return setup(INTERNVL, head_scale=1.0)


@pytest.fixture(scope="module")
def s():
    return setup(INTERNVL)


@pytest.mark.parametrize("mode", [masks.BIDIRECTIONAL, masks.BLOCK_CAUSAL,
                                  masks.CAUSAL])
def test_forward_with_prefix(plain, mode):
    """Logits, hidden states and K/V emissions over prefix + tokens: the
    prefix rows come first, and count in ``prompt_len``."""
    s = plain
    off = s.cfg.n_prefix_embeds
    tokens = np.random.default_rng(2).integers(0, s.cfg.vocab_size, (b, 12))
    pre = extras(s.cfg, b)["prefix_embeds"]
    want = jax_forward(s.jparams, jnp.asarray(tokens), cfg=s.jcfg, mode=mode,
                       prompt_len=off + P, block_size=B,
                       prefix_embeds=jnp.asarray(pre))
    got = forward(s.params, torch.as_tensor(tokens), cfg=s.cfg, device="cpu",
                  mode=mode, prompt_len=off + P, block_size=B,
                  prefix_embeds=torch.as_tensor(pre),
                  prefill_attention_fn=flash_block_attention)
    assert got.logits.shape == (b, off + 12, s.cfg.vocab_size)
    for g, w in ((got.logits, want.logits), (got.hidden, want.hidden)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=STACK_TOL)
    for g, w in zip(got.emissions, want.emissions):
        for k in ("k", "v"):
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]),
                                       rtol=0, atol=STACK_TOL)


def test_lane_block_forward_at_the_offset(plain):
    """The prefill of prefix + prompt committed, then each lane's block at
    its own canvas start (lane 1 a block later): the port's per-lane
    forward reads positions and cache length ``pos_offset`` past the
    canvas start, as the reference's does."""
    s = plain
    off, T = s.cfg.n_prefix_embeds, P + 2 * B
    tokens = np.random.default_rng(3).integers(0, s.cfg.vocab_size, (b, T))
    pre = extras(s.cfg, b)["prefix_embeds"]
    kw = dict(prompt_len=P, gen_len=2 * B, block_size=B, pos_offset=off)
    jkv = JC.commit(JC.init_cache(s.jcfg, b, T + off), jax_forward(
        s.jparams, jnp.asarray(tokens[:, :P]), cfg=s.jcfg,
        mode="block_causal", prompt_len=off + P, block_size=B,
        prefix_embeds=jnp.asarray(pre)).emissions, 0)
    kv = C.commit(C.init_cache(s.cfg, b, T + off, device="cpu"), forward(
        s.params, torch.as_tensor(tokens[:, :P]), cfg=s.cfg, device="cpu",
        mode=masks.BLOCK_CAUSAL, prompt_len=off + P, block_size=B,
        prefix_embeds=torch.as_tensor(pre)).emissions, 0)
    starts = np.array([P, P])
    want, _ = JB.lane_block_forward(s.jparams, jnp.asarray(tokens),
                                    jnp.asarray(starts), jkv, cfg=s.jcfg,
                                    spec=JB.SamplerSpec(**kw))
    got, _ = TB.lane_block_forward(s.params, torch.as_tensor(tokens),
                                   torch.as_tensor(starts), kv, cfg=s.cfg,
                                   spec=TB.SamplerSpec(**kw),
                                   moe_per_row=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=STACK_TOL)


@pytest.mark.parametrize("name", DECODERS)
def test_greedy(s, name):
    check_decoder(s, name, layouts=(("dense", "paged") if name == "cdlm"
                                    else ("dense",)))


def test_sampled_cdlm(s):
    check_decoder(s, "cdlm", temperature=0.7, layouts=("dense", "paged"))
