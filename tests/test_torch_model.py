"""The port's dense decoder against the JAX package's, on one set of params
(built by the JAX ``init_model``, handed over as numpy): the full-sequence
forward in all three mask modes, the cached per-lane block decode
(``lane_block_forward``) with and without the decode attention wrapper,
and one bf16 forward. fp32 at 1e-4; bf16 at 2e-2."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.core import masks as jmasks  # noqa: E402
from repro.core.block_loop import SamplerSpec as JaxSpec  # noqa: E402
from repro.core.block_loop import lane_block_forward as jax_lane  # noqa: E402
from repro.models import forward as jax_forward  # noqa: E402
from repro.models import init_model  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.block_loop import SamplerSpec  # noqa: E402
from repro_torch.core.block_loop import lane_block_forward  # noqa: E402
from repro_torch.kernels.decode_attn import decode_attention  # noqa: E402
from repro_torch.models import forward  # noqa: E402

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

P, G, B = 8, 16, 4
TOL = 1e-4


def _configs(**kw):
    return (jax_get_config("qwen2-0.5b").reduced(dtype="float32", **kw),
            get_config("qwen2-0.5b").reduced(dtype="float32", **kw))


def _np_params(jcfg, seed=0):
    """JAX-initialized params as numpy, with nonzero QKV biases so that the
    bias path is exercised."""
    tree = jax.tree_util.tree_map(np.asarray,
                                  init_model(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    attn = tree["slots"][0]["attn"]
    for name in ("bq", "bk", "bv"):
        attn[name] = rng.normal(0, 0.1, attn[name].shape).astype(np.float32)
    return tree


def _jax(tree, dtype=jnp.float32):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), tree)


def _close(got, want, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("mode", [jmasks.BIDIRECTIONAL, jmasks.BLOCK_CAUSAL,
                                  jmasks.CAUSAL])
def test_full_sequence_forward_matches_jax(mode):
    jcfg, cfg = _configs()
    tree = _np_params(jcfg)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, P + G))
    want = jax_forward(_jax(tree), jnp.asarray(tokens), cfg=jcfg, mode=mode,
                       prompt_len=P, block_size=B)
    got = forward(params_from_jax(tree, cfg, "cpu"), torch.as_tensor(tokens),
                  cfg=cfg, device="cpu", mode=mode, prompt_len=P,
                  block_size=B)
    _close(got.logits, want.logits)
    _close(got.hidden, want.hidden)
    for key in ("k", "v"):
        _close(got.emissions[0][key], want.emissions[0][key])


def test_return_logits_false_skips_the_head():
    _, cfg = _configs()
    params = params_from_jax(_np_params(_configs()[0]), cfg, "cpu")
    out = forward(params, torch.zeros((1, 4), dtype=torch.int64), cfg=cfg,
                  device="cpu", return_logits=False)
    assert out.logits is None and out.hidden.shape == (1, 4, cfg.d_model)


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("attn", ["decode_attention", "generic"])
def test_cached_lane_decode_matches_jax(attn, window):
    """Lanes at different block offsets (per-lane cache_len and positions)
    against the JAX per-lane (vmapped) block forward."""
    kw = {} if window is None else {"long_context_window": window}
    jcfg, cfg = _configs(**kw)
    tree = _np_params(jcfg)
    rng = np.random.default_rng(2)
    b, T = 3, P + G
    tokens = rng.integers(0, cfg.vocab_size, (b, T))
    starts = np.array([P, P + B, P + 3 * B])
    shape = (cfg.n_periods, b, T, cfg.n_kv_heads, cfg.head_dim)
    kc, vc = (rng.normal(0, 1, shape).astype(np.float32) for _ in range(2))
    jspec = JaxSpec(prompt_len=P, gen_len=G, block_size=B)
    spec = SamplerSpec(prompt_len=P, gen_len=G, block_size=B)
    params = params_from_jax(tree, cfg, "cpu")
    fn = decode_attention if attn == "decode_attention" else None
    for hidden in (False, True):
        want, want_em = jax_lane(
            _jax(tree), jnp.asarray(tokens), jnp.asarray(starts),
            ({"k": jnp.asarray(kc), "v": jnp.asarray(vc)},), cfg=jcfg,
            spec=jspec, use_long_window=window is not None,
            return_hidden=hidden)
        cache = ({"k": torch.as_tensor(kc), "v": torch.as_tensor(vc)},)
        got, got_em = lane_block_forward(
            params, torch.as_tensor(tokens), starts, cache, cfg=cfg,
            spec=spec, return_hidden=hidden, decode_attention_fn=fn,
            use_long_window=window is not None, moe_per_row=True)
        _close(got, want)
        for key in ("k", "v"):
            _close(got_em[0][key], want_em[0][key])


def test_bf16_forward_matches_jax():
    jcfg = jax_get_config("qwen2-0.5b").reduced(dtype="bfloat16")
    cfg = get_config("qwen2-0.5b").reduced(dtype="bfloat16")
    tree = _np_params(_configs()[0])
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, P + G))
    want = jax_forward(_jax(tree, jnp.bfloat16), jnp.asarray(tokens),
                       cfg=jcfg, mode=jmasks.BLOCK_CAUSAL, prompt_len=P,
                       block_size=B)
    got = forward(params_from_jax(tree, cfg, "cpu"), torch.as_tensor(tokens),
                  cfg=cfg, device="cpu", mode=jmasks.BLOCK_CAUSAL,
                  prompt_len=P, block_size=B)
    assert got.hidden.dtype == torch.bfloat16
    _close(got.logits, want.logits, tol=2e-2)


@pytest.mark.parametrize("remat", [False, True])
def test_each_stacked_leaf_reaches_the_backward_once(remat):
    """The forward splits each period-stacked leaf once (``unbind``), so the
    backward graph reaches each stacked leaf's ``AccumulateGrad`` through
    one edge (the unbind's), not through one whole-stack index per period,
    with ``remat`` off and on."""
    from repro_torch import tree as T
    _, cfg = _configs(n_layers=3)
    params = params_from_jax(_np_params(_configs(n_layers=3)[0]), cfg, "cpu")
    stacked = [leaf for path, leaf in T.leaves_with_path(params)
               if path[0] == "slots"]
    assert cfg.n_periods == 3 and stacked
    assert all(leaf.shape[0] == cfg.n_periods for leaf in stacked)
    for leaf in T.leaves(params):
        leaf.requires_grad_()
    tokens = torch.as_tensor(
        np.random.default_rng(4).integers(0, cfg.vocab_size, (2, P + G)))
    out = forward(params, tokens, cfg=cfg, device="cpu",
                  mode=jmasks.BLOCK_CAUSAL, prompt_len=P, block_size=B,
                  remat=remat).logits.sum()
    edges, seen, stack = {}, set(), [out.grad_fn]
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        for nxt, _ in node.next_functions:
            if nxt is not None and hasattr(nxt, "variable"):
                key = id(nxt.variable)
                edges[key] = edges.get(key, 0) + 1
            stack.append(nxt)
    assert [edges.get(id(leaf), 0) for leaf in stacked] == [1] * len(stacked)


def test_forward_refuses_params_on_another_device():
    _, cfg = _configs()
    params = params_from_jax(_np_params(_configs()[0]), cfg, "cpu")
    with pytest.raises(ValueError, match="params live on"):
        forward(params, torch.zeros((1, 4), dtype=torch.int64), cfg=cfg,
                device="meta")


def test_chunked_attention_matches_jax():
    """The online-softmax path that ``impl='auto'`` takes at Lk >= 4096,
    forced at a small size with chunks that do not divide Lk."""
    from repro.models import layers as jax_layers
    from repro_torch.core import masks
    from repro_torch.models import layers
    rng = np.random.default_rng(4)
    b, Lq, Kv, Gq, hd = 2, 20, 2, 3, 16
    q = rng.normal(0, 1, (b, Lq, Kv, Gq, hd)).astype(np.float32)
    k, v = (rng.normal(0, 1, (b, Lq, Kv, hd)).astype(np.float32)
            for _ in range(2))
    pos = np.arange(Lq)
    jbias = jmasks.make_bias_fn(mode=jmasks.BLOCK_CAUSAL, prompt_len=4,
                                block_size=4)
    tbias = masks.make_bias_fn(mode=masks.BLOCK_CAUSAL, prompt_len=4,
                               block_size=4)
    want = jax_layers.attention_core(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_pos=jnp.asarray(pos),
        kv_pos=jnp.asarray(pos),
        bias_fn=lambda qp, kp, ok: jnp.where(ok[None, :], jbias(qp, kp),
                                             jmasks.NEG_INF),
        scale=0.25, cap=3.0, impl="chunked", chunk=6)
    for impl in ("chunked", "dense"):
        got = layers.attention_core(
            torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
            q_pos=torch.as_tensor(pos), kv_pos=torch.as_tensor(pos),
            bias_fn=lambda qp, kp, ok: torch.where(ok[None, :], tbias(qp, kp),
                                                   masks.NEG_INF),
            scale=0.25, cap=3.0,
            impl=impl, chunk=6)
        _close(got, want)


def test_cache_commit_and_reset_match_jax():
    from repro.core import cache as jax_cache
    from repro_torch.core import cache
    jcfg, cfg = _configs()
    rng = np.random.default_rng(5)
    b, S, L = 3, 12, 4
    jc = jax_cache.init_cache(jcfg, b, S)
    tc = cache.init_cache(cfg, b, S, device="cpu")
    em = rng.normal(0, 1, (cfg.n_periods, b, L, cfg.n_kv_heads,
                           cfg.head_dim)).astype(np.float32)
    ems_j = ({"k": jnp.asarray(em), "v": jnp.asarray(-em)},)
    ems_t = ({"k": torch.as_tensor(em), "v": torch.as_tensor(-em)},)
    offsets, rows = np.array([0, 4, 8]), np.array([True, False, True])
    jc = jax_cache.commit_rows(jc, ems_j, offsets, rows)
    cache.commit_rows(tc, ems_t, offsets, rows)
    for key in ("k", "v"):
        _close(tc[0][key], jc[0][key], tol=0)
    jc = jax_cache.reset(jc, np.array([2]))
    cache.reset(tc, np.array([2]))
    for key in ("k", "v"):
        _close(tc[0][key], jc[0][key], tol=0)
    with pytest.raises(ValueError, match="outside"):
        cache.commit_rows(tc, ems_t, 10, rows)
