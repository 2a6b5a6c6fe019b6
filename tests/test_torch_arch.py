"""The port's forward for the Gemma pair and the MoE configs against the
JAX package's ``repro.models.forward``, on one set of params (built by the
JAX ``init_model``, handed over as numpy), at ``ModelConfig.reduced()`` in
fp32: gemma-7b (GeGLU, the embedding scale, tied), gemma2-27b (local and
global slots, attention and final softcaps, ``query_pre_attn_scalar``),
llama4-maverick (an MLP slot and an MOE slot, one expert of 4 routed and
a shared one) and kimi-k2 (MOE slots, top 2, a shared expert); and the
head dims the attention kernels gained, through ``dataclasses.replace``
of a reduced config: gemma-7b at head_dim 256, kimi-k2 at 112. Logits,
hidden states and the MoE aux loss within 1e-5 (fp32: the same arithmetic
in another order), full-sequence and cached, the cached forward through
the decode attention wrappers (on the CPU their plain versions) on the
dense and the paged layout. And the recurrent-state configs, jamba
(Mamba, attention and MoE slots) and rwkv6 (attention-free, layernorm):
the forward, every slot's emissions (K/V and end states) and two cached
blocks after a committed prompt, within 1e-4 (``REC_TOL``: depth
compounds the summation order), cached == recompute within 1e-5. Also the
small pieces these configs read:
gelu as JAX computes it, the embedding scale in bf16 bit for bit, the
cache's layout and bytes, the parameter counts, the diffusion timesteps
and transition probabilities."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.core import cache as jax_cache  # noqa: E402
from repro.core import diffusion as JD  # noqa: E402
from repro.core import masks as jmasks  # noqa: E402
from repro.models import forward as jax_forward  # noqa: E402
from repro.models import init_model  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import ARCHITECTURES, get_config  # noqa: E402
from repro_torch.core import cache as C  # noqa: E402
from repro_torch.core import diffusion as D  # noqa: E402
from repro_torch.kernels.block_attn import flash_block_attention  # noqa: E402
from repro_torch.kernels.decode_attn import (  # noqa: E402
    decode_attention,
    paged_decode_attention,
)
from repro_torch.models import forward  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

torch.set_num_threads(2)

P, G, B = 8, 16, 4
TOL = 1e-5
ARCHS = ("gemma-7b", "gemma2-27b", "llama4-maverick-400b-a17b",
         "kimi-k2-1t-a32b")
# (name, overrides of reduced()): the four configs, the new head dims, and
# gemma2 with a window shorter than the sequence, so its local slots mask
CASES = [(a, {}) for a in ARCHS] + [
    ("gemma-7b", {"head_dim": 256}),
    ("kimi-k2-1t-a32b", {"head_dim": 112}),
    ("gemma2-27b", {"sliding_window": 5}),
]
IDS = [n + "".join(f"-{k}{v}" for k, v in kw.items()) for n, kw in CASES]


def _cfgs(name, dtype="float32", **kw):
    """(JAX config, port config): ``reduced()`` in ``dtype`` (fp32), then
    ``kw`` through ``dataclasses.replace``."""
    jcfg = jax_get_config(name).reduced(dtype=dtype)
    cfg = get_config(name).reduced(dtype=dtype)
    return dataclasses.replace(jcfg, **kw), dataclasses.replace(cfg, **kw)


def _tree(jcfg, seed=0):
    return jax.tree_util.tree_map(np.asarray,
                                  init_model(jax.random.PRNGKey(seed), jcfg))


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


def _same_outputs(got, want):
    _close(got.logits, want.logits)
    _close(got.hidden, want.hidden)
    _close(got.aux_loss, want.aux_loss)
    for g, w in zip(got.emissions, want.emissions):
        for key in ("k", "v"):
            _close(g[key], w[key])


@pytest.mark.parametrize("name,kw", CASES, ids=IDS)
@pytest.mark.parametrize("mode", [jmasks.BLOCK_CAUSAL, jmasks.BIDIRECTIONAL])
def test_full_sequence_forward_matches_jax(name, kw, mode):
    """The cache-less forward through the block attention wrapper (plain on
    the CPU), with the MoE slots capacity-dropping, as the reference's
    training and prefill forwards are."""
    jcfg, cfg = _cfgs(name, **kw)
    tree = _tree(jcfg)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                               (2, P + G))
    want = jax_forward(_jax(tree), jnp.asarray(tokens), cfg=jcfg, mode=mode,
                       prompt_len=P, block_size=B)
    got = forward(params_from_jax(tree, cfg, "cpu"), torch.as_tensor(tokens),
                  cfg=cfg, device="cpu", mode=mode, prompt_len=P,
                  block_size=B, prefill_attention_fn=flash_block_attention)
    _same_outputs(got, want)
    if cfg.n_experts:
        assert got.aux_loss.item() > 0
    else:
        assert got.aux_loss.item() == 0


@pytest.mark.parametrize("name,kw", CASES, ids=IDS)
def test_cached_block_forward_matches_jax(name, kw):
    """A block at positions P+B.. against a cache of the first P+B tokens'
    emissions: the reference's generic attention against the port's decode
    attention wrappers on the dense cache and on a shuffled paged pool
    (equal to the dense one), the MoE slots dropless as the reference's
    cached forward defaults to."""
    jcfg, cfg = _cfgs(name, **kw)
    tree = _tree(jcfg)
    jp, params = _jax(tree), params_from_jax(tree, cfg, "cpu")
    b, T, start = 3, P + G, P + B
    rng = np.random.default_rng(2)
    canvas = rng.integers(0, cfg.vocab_size, (b, T))
    kwf = dict(mode=jmasks.BLOCK_CAUSAL, prompt_len=P, block_size=B)
    jout = jax_forward(jp, jnp.asarray(canvas[:, :start]), cfg=jcfg, **kwf)
    jc = jax_cache.commit(jax_cache.init_cache(jcfg, b, T), jout.emissions,
                          0)
    tout = forward(params, torch.as_tensor(canvas[:, :start]), cfg=cfg,
                   device="cpu", **kwf)
    tc = C.commit(C.init_cache(cfg, b, T, device="cpu"), tout.emissions, 0)
    blk = canvas[:, start:start + B]
    want = jax_forward(jp, jnp.asarray(blk), cfg=jcfg, **kwf, cache=jc,
                       cache_len=start)
    got = forward(params, torch.as_tensor(blk), cfg=cfg, device="cpu",
                  **kwf, cache=tc, cache_len=start,
                  decode_attention_fn=decode_attention)
    _same_outputs(got, want)

    paged = C.init_paged_cache(cfg, b, T, n_pages=3 * b * (T // B),
                               page_size=B, device="cpu")
    order = np.random.default_rng(3).permutation(paged.n_pages)
    paged.page_owner[:] = -2        # taken: alloc hands out shuffled pages
    paged.page_owner[order[:b * (T // B)]] = C.FREE
    C.alloc(paged, np.ones(b, bool), 0, T)
    C.commit_rows(paged, tout.emissions, 0, np.ones(b, bool))
    got_p = forward(params, torch.as_tensor(blk), cfg=cfg, device="cpu",
                    **kwf, cache=paged, cache_len=start,
                    paged_decode_attention_fn=paged_decode_attention)
    assert torch.equal(got_p.logits, got.logits)
    assert torch.equal(got_p.aux_loss, got.aux_loss)


def test_local_slots_take_their_window_over_the_long_one():
    """An ``ATTN_LOCAL`` slot attends within ``sliding_window`` whether or
    not ``use_long_window`` asks for the long window, as in the
    reference; the global slot takes the long window when asked."""
    jcfg, cfg = _cfgs("gemma2-27b", sliding_window=5,
                      long_context_window=9)
    tree = _tree(jcfg)
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size,
                                               (2, P + G))
    outs = []
    for long in (False, True):
        want = jax_forward(_jax(tree), jnp.asarray(tokens), cfg=jcfg,
                           mode=jmasks.BIDIRECTIONAL, use_long_window=long)
        got = forward(params_from_jax(tree, cfg, "cpu"),
                      torch.as_tensor(tokens), cfg=cfg, device="cpu",
                      mode=jmasks.BIDIRECTIONAL, use_long_window=long)
        _same_outputs(got, want)
        outs.append(got.logits)
    assert not torch.allclose(outs[0], outs[1])


def test_gelu_is_the_tanh_approximation_jax_computes():
    x = np.linspace(-6, 6, 4001, dtype=np.float32)
    want = np.asarray(JL._act(jnp.asarray(x), "gelu"))
    got = L.act(torch.as_tensor(x), "gelu").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    exact = torch.nn.functional.gelu(torch.as_tensor(x)).numpy()
    assert np.abs(exact - want).max() > 1e-4      # torch's default differs


@pytest.mark.parametrize("name", ["gemma-7b", "gemma2-27b"])
def test_embed_scale_equals_the_reference_in_bf16(name):
    """The scale is rounded to bf16 before the product, as the reference
    rounds it (sqrt(3072) = 55.43 -> 55.5): every entry equals JAX's bit
    for bit at the config's full d_model."""
    cfg, jcfg = get_config(name), jax_get_config(name)
    assert cfg.embed_scale and cfg.d_model in (3072, 4608)
    rng = np.random.default_rng(0)
    tok = jnp.asarray(rng.standard_normal((64, cfg.d_model)), jnp.bfloat16)
    ids = rng.integers(0, 64, (4, 1024))
    want = JL.embed_tokens({"tok": tok}, jnp.asarray(ids), jcfg)
    got = L.embed_tokens(
        {"tok": torch.tensor(np.asarray(tok.astype(jnp.float32))).bfloat16()},
        torch.as_tensor(ids), cfg)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("name", sorted(ARCHITECTURES))
def test_parameter_counts_and_backbone_predicates(name):
    mine, theirs = get_config(name), jax_get_config(name)
    assert mine.param_count() == theirs.param_count()
    assert mine.active_param_count() == theirs.active_param_count()
    assert mine.is_attention_free == theirs.is_attention_free
    assert mine.supports_bidirectional == theirs.supports_bidirectional


@pytest.mark.parametrize("name", ["gemma2-27b", "kimi-k2-1t-a32b",
                                  "jamba-v0.1-52b", "rwkv6-1.6b"])
def test_cache_layout_and_bytes_match_jax(name):
    """``ATTN_LOCAL`` slots hold K/V as ``ATTN`` slots do, in both layouts;
    a Mamba slot holds ``conv`` (the model's dtype) and ``ssm`` (fp32), an
    RWKV slot ``S`` (fp32) and ``tm_shift``, its channel mix
    ``cm_shift``, dense in both layouts; ``cache_bytes`` counts what the
    reference's counts. An attention-free config has no paged layout, as
    in the reference."""
    for dtype in ("float32", "bfloat16"):
        jcfg, cfg = _cfgs(name, dtype=dtype)
        jc = jax_cache.init_cache(jcfg, 2, 16)
        tc = C.init_cache(cfg, 2, 16, device="cpu")
        for g, w in zip(tc, jc):
            assert sorted(g) == sorted(w)
            assert all(tuple(g[k].shape) == w[k].shape for k in g)
            assert all(str(g[k].dtype) == f"torch.{w[k].dtype}" for k in g)
        assert C.cache_bytes(tc) == jax_cache.cache_bytes(jc)
        if cfg.is_attention_free:
            for init in (jax_cache.init_paged_cache, C.init_paged_cache):
                kw = {} if init is jax_cache.init_paged_cache else \
                    {"device": "cpu"}
                with pytest.raises(ValueError, match="paged layout needs "
                                   "attention KV"):
                    init(cfg, 2, 16, n_pages=6, page_size=4, **kw)
            continue
        jp = jax_cache.init_paged_cache(jcfg, 2, 16, n_pages=6, page_size=4)
        tp = C.init_paged_cache(cfg, 2, 16, n_pages=6, page_size=4,
                                device="cpu")
        for g, w in zip(tp.slots, jp.slots):
            assert sorted(g) == sorted(w)
            assert all(tuple(g[k].shape) == w[k].shape for k in g)
        assert tp.page_size == jp.page_size == 4
        assert C.cache_bytes(tp) == jax_cache.cache_bytes(jp)


# ---------------------------------------------------------------------------
# the recurrent-state configs: jamba (Mamba, attention, MoE) and rwkv6
# ---------------------------------------------------------------------------
# The whole stack within 1e-4: jamba's 16 reduced layers compound the
# matmuls' and recurrences' summation order (layer 0's in-projection
# differs from JAX's by 1.7e-6 at magnitude 3.8, the last layer's by 2e-5;
# each module alone agrees within 1e-5, tests/test_torch_ssm.py), the
# JAX tests' own limit for these modules (tests/test_rwkv_mamba.py).
REC_TOL = 1e-4
RECURRENT = [("jamba-v0.1-52b", jmasks.BLOCK_CAUSAL),
             ("rwkv6-1.6b", jmasks.CAUSAL)]


def _all_emissions_close(got, want, tol=REC_TOL):
    for g, w in zip(got.emissions, want.emissions):
        assert sorted(g) == sorted(w)
        for key in w:
            _close(g[key], w[key], tol)


@pytest.mark.parametrize("name,mode", RECURRENT,
                         ids=[n for n, _ in RECURRENT])
def test_recurrent_forward_matches_jax(name, mode):
    """Block-causal for jamba, causal for attention-free rwkv6, as the
    reference's ``tests/test_arch_smoke.py`` runs them: logits, hidden,
    the MoE aux loss and every slot's emission (K/V and end states)."""
    jcfg, cfg = _cfgs(name)
    tree = _tree(jcfg)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                               (2, P + G))
    want = jax_forward(_jax(tree), jnp.asarray(tokens), cfg=jcfg, mode=mode,
                       prompt_len=P, block_size=B)
    got = forward(params_from_jax(tree, cfg, "cpu"), torch.as_tensor(tokens),
                  cfg=cfg, device="cpu", mode=mode, prompt_len=P,
                  block_size=B, prefill_attention_fn=flash_block_attention)
    _close(got.logits, want.logits, REC_TOL)
    _close(got.hidden, want.hidden, REC_TOL)
    _close(got.aux_loss, want.aux_loss, REC_TOL)
    _all_emissions_close(got, want)
    assert (got.aux_loss.item() > 0) == bool(cfg.n_experts)


@pytest.mark.parametrize("name,mode", RECURRENT,
                         ids=[n for n, _ in RECURRENT])
def test_recurrent_cached_blocks_match_jax_and_recompute(name, mode):
    """The prompt's emissions committed (K/V rows and end states), then
    block 0 against that cache: equal to the reference's cached block, and
    to the port's full recompute within 1e-5 (the same loop from the same
    state, the reference's own test allowing 5e-4); its emissions
    committed at P, block 1 equal to the recompute too (the reference's
    second-block exactness). jamba on the dense cache and on a paged pool
    (equal to the dense one bit for bit), rwkv6 dense."""
    jcfg, cfg = _cfgs(name)
    tree = _tree(jcfg)
    jp, params = _jax(tree), params_from_jax(tree, cfg, "cpu")
    b, T = 2, P + 2 * B
    canvas = np.random.default_rng(2).integers(0, cfg.vocab_size, (b, T))
    kwf = dict(mode=mode, prompt_len=P, block_size=B)
    full = forward(params, torch.as_tensor(canvas), cfg=cfg, device="cpu",
                   moe_per_row=False, **kwf)
    jout = jax_forward(jp, jnp.asarray(canvas[:, :P]), cfg=jcfg, **kwf)
    jc = jax_cache.commit(jax_cache.init_cache(jcfg, b, T), jout.emissions,
                          0)
    want = jax_forward(jp, jnp.asarray(canvas[:, P:P + B]), cfg=jcfg, **kwf,
                       cache=jc, cache_len=P)
    tout = forward(params, torch.as_tensor(canvas[:, :P]), cfg=cfg,
                   device="cpu", **kwf)
    dense = C.commit(C.init_cache(cfg, b, T, device="cpu"), tout.emissions,
                     0)
    caches = [("dense", dense, {"decode_attention_fn": decode_attention})]
    if not cfg.is_attention_free:
        paged = C.init_paged_cache(cfg, b, T, n_pages=b * T // B,
                                   page_size=B, device="cpu")
        C.alloc(paged, np.ones(b, bool), 0, T)
        C.commit_rows(paged, tout.emissions, 0, np.ones(b, bool))
        caches.append(("paged", paged,
                       {"paged_decode_attention_fn": paged_decode_attention}))
    first = {}
    for layout, cache, fns in caches:
        blocks = []
        for blk in range(2):
            s0 = P + blk * B
            out = forward(params, torch.as_tensor(canvas[:, s0:s0 + B]),
                          cfg=cfg, device="cpu", **kwf, cache=cache,
                          cache_len=s0, **fns)
            _close(out.logits, full.logits[:, s0:s0 + B])
            C.commit_rows(cache, out.emissions, s0, np.ones(b, bool))
            blocks.append(out)
        first[layout] = blocks[0]
        _close(blocks[0].logits, want.logits, REC_TOL)
        _all_emissions_close(blocks[0], want)
    if "paged" in first:
        assert torch.equal(first["paged"].logits, first["dense"].logits)
        for g, w in zip(C.gather_dense(caches[1][1]), dense):
            for key in w:
                if key not in ("k", "v"):      # states: one per lane
                    assert torch.equal(g[key], w[key]), key


def test_timesteps_and_transition_probs_match_jax():
    assert D.timestep(0, 10) == JD.timestep(0, 10) == 1.0
    assert D.timestep(10, 10) == JD.timestep(10, 10) == 0.0
    assert D.timestep(3, 7) == JD.timestep(3, 7)
    p = np.array(jax.nn.softmax(jnp.arange(5.0)))
    for t, s in ((0.9, 0.3), (0.5, 0.0), (1.0, 0.99)):
        for masked in (True, False):
            want = JD.transition_probs(t, s, masked, jnp.asarray(p))
            got = D.transition_probs(t, s, masked, torch.as_tensor(p))
            assert got["keep"] == want["keep"]
            assert got["still_masked"] == want["still_masked"]
            np.testing.assert_allclose(got["unmask"].numpy(),
                                       np.asarray(want["unmask"]),
                                       rtol=1e-6)
            total = (got["keep"] + got["still_masked"]
                     + float(got["unmask"].sum()))
            assert abs(total - 1.0) < 1e-5
    with pytest.raises(ValueError):
        D.transition_probs(0.3, 0.5, True, torch.as_tensor(p))
