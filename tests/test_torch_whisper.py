"""whisper-base's modules and forward in the port against the JAX package,
at ``reduced()`` fp32 with 3 encoder layers against 2 decoder layers
(``_torch_extras.py``): the sinusoidal table, the plain gelu MLP, the
encoder and one cross-attention slot within 1e-5; the forward with frame
embeddings in the three mask modes, and the cached block forward over the
prefill's committed ``ck``/``cv`` (against recompute and the JAX cached
forward), within 1e-4; the cache's cross-attention leaves and their
commit semantics (a block's emission lacks them, so they stay); the
params' npz keys; the greedy trajectory collector with frames; and the
refusals the reference makes."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_extras import (  # noqa: E402
    WHISPER,
    configs,
    extras,
    setup,
    to_jax,
    to_torch,
)
from repro.checkpoint import save  # noqa: E402
from repro.configs.base import CDLMConfig as JaxCDLM  # noqa: E402
from repro.core import cache as JC  # noqa: E402
from repro.core import trajectory as jtraj  # noqa: E402
from repro.models import forward as jax_forward  # noqa: E402
from repro.models import init_model  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import CDLMConfig  # noqa: E402
from repro_torch.core import trajectory as traj  # noqa: E402
from repro_torch.core import cache as C  # noqa: E402
from repro_torch.core import masks  # noqa: E402
from repro_torch.kernels.block_attn import flash_block_attention  # noqa: E402
from repro_torch.kernels.decode_attn import decode_attention  # noqa: E402
from repro_torch.models import forward  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

torch.set_num_threads(2)

MODULE_TOL = 1e-5     # one module, fp32
STACK_TOL = 1e-4      # the whole stack, fp32
b, P, B = 2, 8, 4


@pytest.fixture(scope="module")
def s():
    # the JAX init's head as it is: the decode tests' scaled head would
    # scale the logits' error with it
    return setup(WHISPER, head_scale=1.0)


def _np(x):
    return np.asarray(x)


def _slot(tree, p=0):
    """Period ``p`` of decoder slot 0, as numpy."""
    return jax.tree_util.tree_map(lambda a: np.asarray(a)[p],
                                  tree["slots"][0])


# The table at whisper's 1,500 encoder positions: XLA's fp32 exp on the
# CPU is off the correctly rounded value by 1 ulp in 22 of the 256
# frequencies (torch's in 1), and an angle pos * f carries that ulp times
# pos: |d angle| <= 1499 * 2^-24 + the two products' roundings (0.5 ulp of
# an angle < 2048 each, 2^-13), so |d sin| <= 2.1e-4 at full width.
FULL_TABLE_TOL = 1499 * 2.0 ** -24 + 2.0 ** -12


@pytest.mark.parametrize("pos, d, tol", [
    (np.arange(24), 256, MODULE_TOL),
    (np.arange(40).reshape(2, 20), 256, MODULE_TOL),
    (np.arange(1500), 512, FULL_TABLE_TOL)],
    ids=["canvas", "per-lane", "full-width encoder"])
def test_sinusoidal_embedding(pos, d, tol):
    """The table at canvas positions (L,), per-lane positions (b, L) and
    the encoder's ``arange(enc_len)`` at full width (1,500 x 512)."""
    want = JL.sinusoidal_embedding(jnp.asarray(pos), d)
    got = L.sinusoidal_embedding(torch.as_tensor(pos), d)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=tol)


def test_gelu_plain_mlp(s):
    """The non-gated MLP, ``gelu(x W_in) W_out`` with the tanh gelu."""
    mlp = _slot(s.jparams)["mlp"]
    assert sorted(mlp) == ["wi", "wo"]
    x = np.random.default_rng(0).standard_normal(
        (b, 12, s.cfg.d_model)).astype(np.float32)
    want = JL.apply_mlp({k: jnp.asarray(v) for k, v in mlp.items()},
                        jnp.asarray(x), s.jcfg)
    got = L.apply_mlp({k: torch.tensor(v) for k, v in mlp.items()},
                      torch.as_tensor(x), s.cfg)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0,
                               atol=MODULE_TOL)


def _jax_encode(s, frames):
    """The reference's encoder, as its forward runs it."""
    enc = frames + JL.sinusoidal_embedding(jnp.arange(frames.shape[1]),
                                           s.jcfg.d_model)
    ctx = dict(mode="bidirectional", prompt_len=0, block_size=1,
               q_pos=jnp.arange(frames.shape[1]), cache_len=None,
               cache_slot=None, use_long_window=False, attn_impl="auto",
               attention_fn=JL.attention_core, encoder_out=None,
               rwkv_state=None)
    x, _, _ = JT._run_stack(s.jparams["encoder"]["slots"], enc, cfg=s.jcfg,
                            slot_kinds=(("attn", "mlp"),), ctx=ctx)
    return JL.apply_norm(s.jparams["encoder"]["final_norm"], x, s.jcfg)


@pytest.mark.parametrize("attention", ["generic", "kernel wrapper"])
def test_encoder(s, attention):
    """``encode`` over its own 3 layers (the decoder has 2), through the
    generic attention and through the block attention wrapper (its plain
    version on the CPU)."""
    frames = extras(s.cfg, b)["encoder_embeds"]
    want = _jax_encode(s, jnp.asarray(frames))
    fn = flash_block_attention if attention == "kernel wrapper" else None
    got = TT.encode(s.params, torch.as_tensor(frames), cfg=s.cfg,
                    prefill_attention_fn=fn)
    assert s.cfg.n_encoder_layers == 3 and s.cfg.n_periods == 2
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0,
                               atol=MODULE_TOL)


def test_cross_attention_slot(s):
    """One cross-attention sublayer: projected from the encoder's output
    (emitting ``ck``/``cv``), then read back from a cache slot holding
    them (emitting nothing)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((b, 6, s.cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((b, s.cfg.encoder_seq_len,
                               s.cfg.d_model)).astype(np.float32)
    slot = _slot(s.jparams)
    jslot = jax.tree_util.tree_map(jnp.asarray, slot)
    tslot = jax.tree_util.tree_map(torch.tensor, slot)
    want, wem = JT._cross_attention_slot(
        jslot, jnp.asarray(x), cfg=s.jcfg,
        ctx={"cache_slot": None, "encoder_out": jnp.asarray(enc),
             "q_pos": jnp.arange(6)})
    got, gem = TT._cross_attention_slot(
        tslot, torch.as_tensor(x), cfg=s.cfg,
        ctx={"cache_slot": None, "encoder_out": torch.as_tensor(enc)})
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0,
                               atol=MODULE_TOL)
    for k in ("ck", "cv"):
        np.testing.assert_allclose(gem[k].numpy(), _np(wem[k]), rtol=0,
                                   atol=MODULE_TOL)
    again, em = TT._cross_attention_slot(
        tslot, torch.as_tensor(x), cfg=s.cfg,
        ctx={"cache_slot": {"ck": gem["ck"], "cv": gem["cv"]},
             "encoder_out": None})
    assert em == {}
    np.testing.assert_array_equal(again.numpy(), got.numpy())


@pytest.mark.parametrize("mode", [masks.BIDIRECTIONAL, masks.BLOCK_CAUSAL,
                                  masks.CAUSAL])
def test_forward_with_frames(s, mode):
    """Logits, hidden states and every emission (``k``/``v`` and the
    cross attention's ``ck``/``cv``) of the full-sequence forward."""
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, s.cfg.vocab_size, (b, 12))
    ex = extras(s.cfg, b)
    want = jax_forward(s.jparams, jnp.asarray(tokens), cfg=s.jcfg, mode=mode,
                       prompt_len=P, block_size=B,
                       encoder_embeds=jnp.asarray(ex["encoder_embeds"]))
    got = forward(s.params, torch.as_tensor(tokens), cfg=s.cfg, device="cpu",
                  mode=mode, prompt_len=P, block_size=B,
                  encoder_embeds=torch.as_tensor(ex["encoder_embeds"]),
                  prefill_attention_fn=flash_block_attention)
    for g, w in ((got.logits, want.logits), (got.hidden, want.hidden)):
        np.testing.assert_allclose(g.numpy(), _np(w), rtol=0, atol=STACK_TOL)
    for g, w in zip(got.emissions, want.emissions):
        assert sorted(g) == sorted(w) == ["ck", "cv", "k", "v"]
        for k in g:
            np.testing.assert_allclose(g[k].numpy(), _np(w[k]), rtol=0,
                                       atol=STACK_TOL)


def test_cached_block_forward_reads_the_committed_cross_cache(s):
    """Prefill with frames, commit (``ck``/``cv`` into the cache), then
    the next block against the cache without frames: its logits equal a
    full block-causal recompute's and the JAX cached forward's; the block
    emits no ``ck``, so its commit leaves the cross cache as the prefill
    wrote it, and the second block decodes exactly too."""
    rng = np.random.default_rng(3)
    T = P + 2 * B
    tokens = rng.integers(0, s.cfg.vocab_size, (b, T))
    frames = extras(s.cfg, b)["encoder_embeds"]
    tt, tf = torch.as_tensor(tokens), torch.as_tensor(frames)
    jt, jf = jnp.asarray(tokens), jnp.asarray(frames)
    ref = forward(s.params, tt, cfg=s.cfg, device="cpu",
                  mode=masks.BLOCK_CAUSAL, prompt_len=P, block_size=B,
                  encoder_embeds=tf)
    kv = C.init_cache(s.cfg, b, T, device="cpu")
    jkv = JC.init_cache(s.jcfg, b, T)
    pre = forward(s.params, tt[:, :P], cfg=s.cfg, device="cpu",
                  mode=masks.BLOCK_CAUSAL, prompt_len=P, block_size=B,
                  encoder_embeds=tf)
    C.commit(kv, pre.emissions, 0)
    jkv = JC.commit(jkv, jax_forward(
        s.jparams, jt[:, :P], cfg=s.jcfg, mode="block_causal", prompt_len=P,
        block_size=B, encoder_embeds=jf).emissions, 0)
    cross = [{k: slot[k].clone() for k in ("ck", "cv")} for slot in kv]
    for blk in range(2):
        start = P + blk * B
        got = forward(s.params, tt[:, start:start + B], cfg=s.cfg,
                      device="cpu", mode=masks.BLOCK_CAUSAL, prompt_len=P,
                      block_size=B, cache=kv, cache_len=start,
                      decode_attention_fn=decode_attention)
        want = jax_forward(s.jparams, jt[:, start:start + B], cfg=s.jcfg,
                           mode="block_causal", prompt_len=P, block_size=B,
                           positions=start + jnp.arange(B), cache=jkv,
                           cache_len=start)
        np.testing.assert_allclose(got.logits.numpy(),
                                   ref.logits[:, start:start + B].numpy(),
                                   rtol=0, atol=STACK_TOL)
        np.testing.assert_allclose(got.logits.numpy(), _np(want.logits),
                                   rtol=0, atol=STACK_TOL)
        assert all(sorted(em) == ["k", "v"] for em in got.emissions)
        C.commit(kv, got.emissions, start)
        jkv = JC.commit(jkv, want.emissions, start)
        for slot, c in zip(kv, cross):
            for k in ("ck", "cv"):
                assert torch.equal(slot[k], c[k])
    for slot, jslot in zip(kv, jkv):
        for k in slot:
            np.testing.assert_allclose(slot[k].numpy(), _np(jslot[k]),
                                       rtol=0, atol=STACK_TOL)


def test_cache_leaves_and_commit_semantics(s):
    """``init_cache`` holds ``ck``/``cv`` (n_periods, b, encoder_seq_len,
    Kv, hd) beside K/V, as the reference's; ``cache_bytes`` counts them.
    ``commit``, ``commit_at`` and ``commit_rows`` replace them from an
    emission that holds them and keep them from one that does not (the
    emission's keys are walked); ``reset`` zeroes the lanes' rows."""
    tc = C.init_cache(s.cfg, b, 16, device="cpu")
    jc = JC.init_cache(s.jcfg, b, 16)
    for g, w in zip(tc, jc):
        assert sorted(g) == sorted(w) == ["ck", "cv", "k", "v"]
        assert all(tuple(g[k].shape) == w[k].shape for k in g)
    assert C.cache_bytes(tc) == JC.cache_bytes(jc)
    n, Kv, hd = s.cfg.n_periods, s.cfg.n_kv_heads, s.cfg.head_dim
    enc = s.cfg.encoder_seq_len
    g = torch.Generator().manual_seed(0)
    cross = {k: torch.randn((n, b, enc, Kv, hd), generator=g)
             for k in ("ck", "cv")}
    kv = {k: torch.randn((n, b, B, Kv, hd), generator=g) for k in ("k", "v")}
    C.commit(tc, ({**kv, **cross},), 0)
    assert torch.equal(tc[0]["ck"], cross["ck"])
    C.commit(tc, (kv,), 4)
    C.commit_at(tc, (kv,), torch.tensor(8))
    C.commit_rows(tc, (kv,), [12, 0], np.array([True, False]))
    assert torch.equal(tc[0]["ck"], cross["ck"])
    assert torch.equal(tc[0]["cv"], cross["cv"])
    assert torch.equal(tc[0]["k"][:, :, 8:12], kv["k"])
    C.commit_rows(tc, ({**kv, "ck": -cross["ck"], "cv": cross["cv"]},),
                  0, np.array([False, True]))
    assert torch.equal(tc[0]["ck"][:, 1], -cross["ck"][:, 1])
    assert torch.equal(tc[0]["ck"][:, 0], cross["ck"][:, 0])
    C.reset(tc, np.array([True, False]))
    assert not tc[0]["ck"][:, 0].any() and tc[0]["ck"][:, 1].any()


def test_npz_checkpoint_keys(tmp_path):
    """The encoder's leaves ("encoder/slots/0/attn/wq", ...) and the
    decoder's cross attention come through a ``checkpoint/io.py`` npz."""
    jcfg, cfg = configs(WHISPER)
    jparams = init_model(jax.random.PRNGKey(0), jcfg)
    path = tmp_path / "ckpt.npz"
    save(jparams, str(path))
    with np.load(path) as data:
        assert "encoder/slots/0/mlp/wi" in data
        assert "slots/0/cross/wq" in data
        params = params_from_jax(data, cfg, "cpu")
    np.testing.assert_array_equal(
        params["encoder"]["slots"][0]["attn"]["wq"].numpy(),
        np.asarray(jparams["encoder"]["slots"][0]["attn"]["wq"]))
    np.testing.assert_array_equal(
        params["slots"][0]["cross"]["wv"].numpy(),
        np.asarray(jparams["slots"][0]["cross"]["wv"]))


def test_refusals(s):
    """The reference's refusals, in its words: the paged layout and the
    continuous engine refuse an encoder-decoder; the serving CLI refuses
    whisper-base (a token prompt cannot give frames)."""
    from repro_torch.configs import ServeConfig
    from repro_torch.launch import serve as serve_cli
    from repro_torch.serving import ContinuousEngine
    with pytest.raises(ValueError, match="paged layout does not support "
                       "encoder-decoder cross-attention caches yet"):
        C.init_paged_cache(s.cfg, 2, 16, n_pages=8, page_size=4,
                           device="cpu")
    with pytest.raises(ValueError, match="does not support encoder-decoder "
                       r"models yet \(per-lane encoder state is not "
                       r"scheduled\)"):
        ContinuousEngine(s.params, s.cfg, ServeConfig(
            max_batch=2, block_size=B, gen_length=8), prompt_len=P,
            device="cpu")
    with pytest.raises(ValueError, match="frame embeddings"):
        serve_cli.main(["--config", WHISPER, "--reduced", "--device", "cpu",
                        "--prompt-len", "8", "--gen-length", "8",
                        "--block-size", "4"])


def test_bf16_frames_and_the_fp32_frames_difference():
    """bf16 params with bf16 frames: the port's logits, hidden states and
    cross-attention K/V within two bf16 ulps of each one's max magnitude
    (2^-6 relative; observed 1.0e-2 on the hidden states) of the
    reference's. fp32 frames with bf16 params: the port casts them to the
    activations' dtype at entry, as it casts a prefix, so its output
    equals the bf16 frames' bit for bit; the reference does not cast
    them, its encoder runs in fp32 and its decoder's scan then refuses the
    fp32 activations the cross attention makes (a TypeError). ROADMAP
    Queue 3 records this as not a fault of the port."""
    import dataclasses
    jcfg, cfg = (dataclasses.replace(c, dtype="bfloat16")
                 for c in configs(WHISPER))
    tree = jax.tree_util.tree_map(np.asarray,
                                  init_model(jax.random.PRNGKey(0), jcfg))
    params = params_from_jax(tree, cfg, "cpu")
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (b, 12))
    frames = extras(cfg, b)["encoder_embeds"]
    f16 = torch.from_numpy(frames).bfloat16()
    kw = dict(mode=masks.BLOCK_CAUSAL, prompt_len=P, block_size=B)
    want = jax_forward(jp, jnp.asarray(tokens), cfg=jcfg,
                       encoder_embeds=jnp.asarray(f16.float().numpy()).astype(
                           jnp.bfloat16), **kw)
    got = forward(params, torch.as_tensor(tokens), cfg=cfg, device="cpu",
                  encoder_embeds=f16, **kw)
    for g, w in ((got.logits, want.logits), (got.hidden, want.hidden),
                 (got.emissions[0]["ck"], want.emissions[0]["ck"])):
        w = np.asarray(w.astype(jnp.float32))
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0,
                                   atol=2.0 ** -6 * np.abs(w).max())
    fp32 = forward(params, torch.as_tensor(tokens), cfg=cfg, device="cpu",
                   encoder_embeds=torch.as_tensor(frames), **kw)
    assert fp32.hidden.dtype == torch.bfloat16
    assert torch.equal(fp32.logits, forward(
        params, torch.as_tensor(tokens), cfg=cfg, device="cpu",
        encoder_embeds=torch.as_tensor(frames).bfloat16(), **kw).logits)
    with pytest.raises(TypeError, match="carry"):
        jax_forward(jp, jnp.asarray(tokens), cfg=jcfg,
                    encoder_embeds=jnp.asarray(frames), **kw)


def test_greedy_collector_with_frames():
    """The greedy trajectory collector with whisper's frames (the encoder
    in every canvas forward), against the JAX ``collect``: trajectories
    exactly, the hidden buffer within 1e-4."""
    s = setup(WHISPER)
    rng = np.random.default_rng(5)
    prompts = rng.integers(2, s.cfg.vocab_size - 1, (2, 8))
    gt = rng.integers(2, s.cfg.vocab_size - 1, (2, 8))
    ex = extras(s.cfg, 2, seed=8)
    kw = dict(block_size=B, gen_length=8, prompt_length=P,
              temperatures=(0.0,))
    want = jtraj.collect(s.jparams, jnp.asarray(prompts), jnp.asarray(gt),
                         cfg=s.jcfg, cdlm=JaxCDLM(**kw),
                         key=jax.random.PRNGKey(0), extras=to_jax(ex))
    got = traj.collect(s.params, torch.as_tensor(prompts),
                       torch.as_tensor(gt), cfg=s.cfg, cdlm=CDLMConfig(**kw),
                       extras=to_torch(ex), fused_select=True)
    for k in ("prompt", "gt", "final", "finalized_at"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    np.testing.assert_allclose(got["hidden"].numpy(), _np(want["hidden"]),
                               rtol=0, atol=STACK_TOL)
