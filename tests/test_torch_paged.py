"""The port's paged KV layout against the JAX package's, on the CPU: the
allocator and the paged cache ops over one call sequence, the plain paged
decode attention against the JAX Pallas kernel (``interpret=True``) and the
JAX oracle, and the paged ``ContinuousEngine`` against the JAX paged engine
on one trace under a tight pool (tokens, steps, finish_reason, call count,
stalls and preemptions). Then the port's own layout invariants, mirroring
``tests/test_paged_cache.py``, ``tests/test_cache_lanes.py``,
``tests/test_tuning.py`` and ``tests/test_serving_api.py``: paged == dense,
a minimum pool with page reuse, mixed max_tokens, no block streamed twice
under preemption, host accounting, and the pool-sizing errors.

Tolerances: the allocator, the cache ops and every engine result are
compared exactly; the plain paged decode against the JAX kernel and oracle
at 1e-4 in fp32 (the sums run in another order), and paged == dense exactly
(the plain paged version gathers and runs the dense math)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ServeConfig as JaxServeConfig  # noqa: E402
from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.core import cache as JC  # noqa: E402
from repro.kernels.decode_attn import (  # noqa: E402
    paged_decode_attention as jax_paged_decode,
)
from repro.kernels.decode_attn import paged_decode_attention_ref  # noqa: E402
from repro.models import init_model  # noqa: E402
from repro.serving import ContinuousEngine as JaxEngine  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import ServeConfig, get_config  # noqa: E402
from repro_torch.core import cache as C  # noqa: E402
from repro_torch.core import masks  # noqa: E402
from repro_torch.kernels.decode_attn import (  # noqa: E402
    decode_attention,
    paged_decode_attention,
)
from repro_torch.kernels.decode_attn import ref as dref  # noqa: E402
from repro_torch.models import forward  # noqa: E402
from repro_torch.serving import ContinuousEngine, Request  # noqa: E402

torch.set_num_threads(2)

JCFG = jax_get_config("qwen2-0.5b").reduced(dtype="float32")
CFG = get_config("qwen2-0.5b").reduced(dtype="float32")
P, G, B = 8, 16, 4
T = P + G
TIGHT = T // B + 2          # too small for two full canvases: stalls
EMBED_SCALE = 40.0          # sharpens the tied head: iterations finalize >1


# ---------------------------------------------------------------------------
# allocator and cache ops
# ---------------------------------------------------------------------------
def test_cache_ops_match_jax_over_one_call_sequence():
    """alloc (with all-or-nothing failures), commit_rows, free, a second
    alloc into recycled pages, another commit: equal ok masks, page tables,
    owners, pools and gathered dense views after every call."""
    b, n_pages = 3, 7
    jc = JC.init_paged_cache(JCFG, b, T, n_pages=n_pages, page_size=B,
                             dtype="float32")
    tc = C.init_paged_cache(CFG, b, T, n_pages=n_pages, page_size=B,
                            device="cpu")
    rng = np.random.default_rng(0)

    def emissions(L):
        em = rng.normal(0, 1, (CFG.n_periods, b, L, CFG.n_kv_heads,
                               CFG.head_dim)).astype(np.float32)
        return (({"k": jnp.asarray(em), "v": jnp.asarray(-em)},),
                ({"k": torch.as_tensor(em), "v": torch.as_tensor(-em)},))

    def same():
        np.testing.assert_array_equal(tc.page_table,
                                      np.asarray(jc.page_table))
        np.testing.assert_array_equal(tc.page_owner,
                                      np.asarray(jc.page_owner))
        assert C.free_page_count(tc) == int(JC.free_page_count(jc))
        for key in ("k", "v"):
            np.testing.assert_array_equal(tc.slots[0][key].numpy(),
                                          np.asarray(jc.slots[0][key]))
            np.testing.assert_array_equal(
                C.gather_dense(tc)[0][key].numpy(),
                np.asarray(JC.gather_dense(jc)[0][key]))

    def alloc(rows, starts, stops):
        nonlocal jc
        jc, jok = JC.alloc(jc, jnp.asarray(rows), jnp.asarray(starts),
                           jnp.asarray(stops))
        _, tok = C.alloc(tc, rows, starts, stops)
        np.testing.assert_array_equal(tok, np.asarray(jok))
        same()
        return tok

    ok = alloc(np.array([True, True, True]), 0, P + B)   # 3 + 3 + 3 > 7
    assert ok.tolist() == [True, True, False]
    je, te = emissions(P)
    jc = JC.commit_rows(jc, je, 0, np.array([True, False, False]))
    C.commit_rows(tc, te, 0, np.array([True, False, False]))
    same()
    ok = alloc(np.array([False, True, False]), np.array([0, P, 0]),
               np.array([0, P + 2 * B, 0]))              # 1 more page
    assert ok.tolist() == [False, True, False]
    je, te = emissions(B)
    offs = np.array([P, P + B, 0])
    jc = JC.commit_rows(jc, je, offs, np.array([True, True, False]))
    C.commit_rows(tc, te, offs, np.array([True, True, False]))
    same()
    jc = JC.free(jc, np.array([True, False, False]))
    C.free(tc, np.array([True, False, False]))
    same()
    ok = alloc(np.array([True, False, True]), 0, np.array([T, 0, P]))
    assert ok.tolist() == [False, False, True]
    je, te = emissions(P)
    jc = JC.commit_rows(jc, je, 0, np.array([False, True, True]))
    C.commit_rows(tc, te, 0, np.array([False, True, True]))
    same()
    with pytest.raises(ValueError, match="outside"):
        C.commit_rows(tc, te, T, np.array([True, False, False]))


def test_commit_rows_paged_writes_only_selected_lanes():
    tc = C.init_paged_cache(CFG, 2, T, n_pages=6, page_size=B, device="cpu")
    C.alloc(tc, np.ones((2,), bool), 0, P)
    em = torch.ones((CFG.n_periods, 2, P, CFG.n_kv_heads, CFG.head_dim))
    C.commit_rows(tc, ({"k": em, "v": em},), 0, np.array([True, False]))
    for key in ("k", "v"):
        pool = tc.slots[0][key]
        assert (pool[:, tc.page_table[1, 0]] == 0).all()
        assert (pool[:, tc.page_table[0, 0]] == 1).all()


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "jamba-v0.1-52b"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_a_prefill_committed_period_by_period_equals_commit_rows(arch, paged):
    """``forward(emit=period_commit(...))`` (the engines' admission) keeps
    no emissions and leaves every cache leaf, K/V pools and recurrent
    states alike, as ``commit_rows`` of the stacked emissions does."""
    from repro_torch.bridge import init_params
    cfg = get_config(arch).reduced(dtype="float32")
    gen = torch.Generator().manual_seed(3)
    params = init_params(cfg, gen, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (3, P), generator=gen)
    rows = np.array([True, False, True])

    def fresh():
        if not paged:
            return C.init_cache(cfg, 3, T, device="cpu")
        c = C.init_paged_cache(cfg, 3, T, n_pages=3 * T // B, page_size=B,
                               device="cpu")
        C.alloc(c, rows, 0, P)
        return c

    kw = dict(cfg=cfg, device="cpu", mode=masks.BLOCK_CAUSAL, prompt_len=P,
              block_size=B, return_logits=False)
    want, got = fresh(), fresh()
    stacked = forward(params, toks, **kw)
    C.commit_rows(want, stacked.emissions, 0, rows)
    out = forward(params, toks, emit=C.period_commit(got, 0, rows), **kw)
    assert out.emissions is None
    assert torch.equal(out.hidden, stacked.hidden)
    slots = (lambda c: c.slots) if paged else (lambda c: c)
    for ws, gs in zip(slots(want), slots(got)):
        assert ws.keys() == gs.keys()
        for key in ws:
            assert torch.equal(ws[key], gs[key]), key


def test_device_table_follows_the_host_table():
    tc = C.init_paged_cache(CFG, 2, T, n_pages=6, page_size=B, device="cpu")
    first = tc.device_table()
    assert tc.device_table() is first               # unchanged: no upload
    C.alloc(tc, np.array([False, True]), 0, B)
    np.testing.assert_array_equal(tc.device_table().numpy(), tc.page_table)
    assert tc.device_table().dtype == torch.int32
    C.free(tc, np.array([False, True]))
    assert (tc.device_table() == C.FREE).all()


# ---------------------------------------------------------------------------
# plain paged decode attention
# ---------------------------------------------------------------------------
def _paged_inputs(b, Bq, Kv, Gq, hd, n_pages, page, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(0, 1, s).astype(np.float32)  # noqa: E731
    return (f(b, Bq, Kv, Gq, hd), f(n_pages, page, Kv, hd),
            f(n_pages, page, Kv, hd), f(b, Bq, Kv, hd), f(b, Bq, Kv, hd))


@pytest.mark.parametrize("page,n_t,lens,window,softcap", [
    (16, 5, (40, 32, 0), None, None),
    (32, 4, (100, 37, 64), 48, None),       # boundary page + window
    (16, 3, (48, 48, 16), None, 30.0),      # full tables + softcap
    (4, 9, (33, 5, 12), 6, 5.0),
])
def test_paged_decode_plain_matches_jax(page, n_t, lens, window, softcap):
    b, Bq, Kv, Gq, hd, n_pages = 3, 8, 2, 4, 64, 30
    q, kp, vp, kb, vb = _paged_inputs(b, Bq, Kv, Gq, hd, n_pages, page,
                                      seed=page + n_t)
    perm = np.random.default_rng(1).permutation(n_pages)
    table = np.full((b, n_t), C.FREE, np.int32)   # -1 past each length
    for lane, ln in enumerate(lens):
        for j in range(-(-ln // page)):
            table[lane, j] = perm[lane * n_t + j]
    lens = np.asarray(lens, np.int32)
    kw = dict(scale=0.125, softcap=softcap, window=window)
    t = [torch.as_tensor(a) for a in (q, kp, vp, kb, vb)]
    before = paged_decode_attention.launches
    got = paged_decode_attention(*t, torch.as_tensor(table),
                                 torch.as_tensor(lens), **kw).numpy()
    assert paged_decode_attention.launches == before  # CPU: no kernel
    j = [jnp.asarray(a) for a in (q, kp, vp, kb, vb)]
    want_kernel = jax_paged_decode(*j, jnp.asarray(table), jnp.asarray(lens),
                                   interpret=True, **kw)
    want_oracle = paged_decode_attention_ref(*j, jnp.asarray(table),
                                             jnp.asarray(lens), **kw)
    np.testing.assert_allclose(got, np.asarray(want_kernel), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got, np.asarray(want_oracle), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("Kv,Gq,hd,window,softcap", [
    (4, 1, 256, None, None),       # gemma-7b's G and head_dim
    (2, 2, 128, 20, 50.0),         # gemma2's local slot, window scaled down
    (2, 8, 112, None, None),       # kimi-k2's G and head_dim
    (2, 8, 112, 20, 50.0),
])
def test_paged_decode_plain_matches_jax_at_new_head_dims(Kv, Gq, hd, window,
                                                         softcap):
    """The plain paged version at the head dims the kernels gained, against
    the JAX kernel (interpret mode) and oracle, fp32 at 1e-4."""
    b, Bq, n_pages, page, n_t, lens = 3, 8, 20, 8, 5, (40, 17, 0)
    q, kp, vp, kb, vb = _paged_inputs(b, Bq, Kv, Gq, hd, n_pages, page,
                                      seed=hd + Gq)
    perm = np.random.default_rng(2).permutation(n_pages)
    table = np.full((b, n_t), C.FREE, np.int32)
    for lane, ln in enumerate(lens):
        for j in range(-(-ln // page)):
            table[lane, j] = perm[lane * n_t + j]
    lens = np.asarray(lens, np.int32)
    kw = dict(scale=hd ** -0.5, softcap=softcap, window=window)
    got = paged_decode_attention(
        *(torch.as_tensor(a) for a in (q, kp, vp, kb, vb)),
        torch.as_tensor(table), torch.as_tensor(lens), **kw).numpy()
    j = [jnp.asarray(a) for a in (q, kp, vp, kb, vb)]
    for want in (jax_paged_decode(*j, jnp.asarray(table), jnp.asarray(lens),
                                  interpret=True, **kw),
                 paged_decode_attention_ref(*j, jnp.asarray(table),
                                            jnp.asarray(lens), **kw)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4,
                                   atol=1e-4)


def test_paged_decode_plain_equals_dense_on_identity_table():
    b, Bq, Kv, Gq, hd, page, n_t = 2, 8, 2, 4, 64, 16, 5
    q, kp, vp, kb, vb = (torch.as_tensor(a) for a in _paged_inputs(
        b, Bq, Kv, Gq, hd, b * n_t, page, seed=7))
    table = torch.arange(b * n_t, dtype=torch.int32).reshape(b, n_t)
    lens = torch.tensor([40, 17], dtype=torch.int32)
    kc = kp.reshape(b, n_t * page, Kv, hd)
    vc = vp.reshape(b, n_t * page, Kv, hd)
    for kw in ({}, {"window": 9, "softcap": 5.0}):
        dense = dref.decode_attention(q, kc, vc, kb, vb, lens, scale=0.125,
                                      **kw)
        paged = paged_decode_attention(q, kp, vp, kb, vb, table, lens,
                                       scale=0.125, **kw)
        assert torch.equal(dense, paged)


# ---------------------------------------------------------------------------
# model: paged cached decode == dense, kernel hook and gather path
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def tree():
    t = jax.tree_util.tree_map(np.asarray,
                               init_model(jax.random.PRNGKey(0), JCFG))
    t["embed"]["tok"] = t["embed"]["tok"] * EMBED_SCALE
    # a zero mask-token row: the mask token is never a candidate, as in a
    # trained model, so decoded spans hold real tokens
    t["embed"]["tok"][CFG.mask_token_id] = 0.0
    return t


@pytest.fixture(scope="module")
def params(tree):
    return params_from_jax(tree, CFG, "cpu")


@pytest.mark.parametrize("attn", ["kernel wrapper", "gather"])
def test_cached_block_decode_paged_equals_dense(params, attn):
    b = 2
    tokens = torch.as_tensor(np.random.default_rng(3).integers(
        2, CFG.vocab_size - 1, (b, T)))
    out = forward(params, tokens[:, :P], cfg=CFG, device="cpu",
                  mode=masks.BLOCK_CAUSAL, prompt_len=P, block_size=B)
    rows = np.ones((b,), bool)
    dense = C.commit_rows(C.init_cache(CFG, b, T, device="cpu"),
                          out.emissions, 0, rows)
    # scattered pages: lane 1 first, in reverse
    paged = C.init_paged_cache(CFG, b, T, n_pages=2 * (T // B),
                               page_size=B, device="cpu")
    C.alloc(paged, np.array([False, True]), 0, T)
    paged.page_table[1] = paged.page_table[1][::-1].copy()
    C.alloc(paged, np.array([True, False]), 0, T)
    paged.touch()
    C.commit_rows(paged, out.emissions, 0, rows)
    kernel = attn == "kernel wrapper"
    kw = dict(cfg=CFG, device="cpu", mode=masks.BLOCK_CAUSAL, prompt_len=P,
              block_size=B, positions=P + torch.arange(B), cache_len=P)
    want = forward(params, tokens[:, P:P + B], cache=dense,
                   decode_attention_fn=decode_attention if kernel else None,
                   **kw)
    got = forward(params, tokens[:, P:P + B], cache=paged,
                  paged_decode_attention_fn=(paged_decode_attention if kernel
                                             else None), **kw)
    assert torch.equal(want.logits, got.logits)


# ---------------------------------------------------------------------------
# the paged engine
# ---------------------------------------------------------------------------
def _serve(cls, **kw):
    return cls(max_batch=2, block_size=B, gen_length=G, conf_threshold=0.5,
               scheduler="continuous", fused_select=True, **kw)


def _prompts(n=5):
    return np.random.default_rng(0).integers(2, CFG.vocab_size - 1, (n, P),
                                             dtype=np.int32)


def _trace(cls):
    """5 requests through 2 lanes with mixed max_tokens."""
    caps = [None, B, None, 2 * B, None]
    return [cls(prompt=p, id=i, max_tokens=c)
            for i, (p, c) in enumerate(zip(_prompts(), caps))]


@pytest.fixture(scope="module")
def jax_tight(tree):
    eng = JaxEngine(jax.tree_util.tree_map(jnp.asarray, tree), JCFG,
                    _serve(JaxServeConfig, cache_layout="paged",
                           page_pool_pages=TIGHT), prompt_len=P)
    outs = {o.id: o for o in eng.generate(_trace(JaxRequest))}
    return outs, int(eng._state.calls), eng.page_pool_stats()


def _engine(params, **kw):
    return ContinuousEngine(params, CFG, _serve(ServeConfig, **kw),
                            prompt_len=P, device="cpu")


@pytest.fixture(scope="module")
def dense_run(params):
    eng = _engine(params)
    return {o.id: o for o in eng.generate(_trace(Request))}


def _same(want, got, steps=True):
    assert sorted(got) == sorted(want)
    for rid, w in want.items():
        np.testing.assert_array_equal(got[rid].tokens, np.asarray(w.tokens),
                                      rid)
        assert got[rid].gen_length == w.gen_length, rid
        assert got[rid].finish_reason == w.finish_reason, rid
        if steps:
            assert got[rid].steps == w.steps, rid


def test_paged_engine_matches_jax_under_a_tight_pool(params, jax_tight):
    want, want_calls, want_stats = jax_tight
    assert want_stats["preemptions"] >= 1 and want_stats["stall_rounds"] >= 1
    eng = _engine(params, cache_layout="paged", page_pool_pages=TIGHT)
    got = {o.id: o for o in eng.generate(_trace(Request))}
    _same(want, got)
    assert eng.call_counts()["total"] == want_calls
    assert eng.page_pool_stats() == want_stats


def test_paged_engine_equals_dense(params, dense_run):
    eng = _engine(params, cache_layout="paged")
    got = {o.id: o for o in eng.generate(_trace(Request))}
    _same(dense_run, got)
    stats = eng.page_pool_stats()
    assert stats["n_pages"] == 2 * (T // B)
    assert stats["preemptions"] == stats["stall_rounds"] == 0
    assert 0 < stats["peak_pages"] <= stats["n_pages"]


@pytest.mark.parametrize("pool", [T // B, TIGHT])
def test_paged_engine_exact_under_page_pressure(params, dense_run, pool):
    """A pool of one full canvas (every request contends for pages and
    recycles them) and a tight one: stalls and preemptions, and every
    request still decodes as on the dense layout. The page accounting
    agrees at every boundary and ends fully free."""
    eng = _engine(params, cache_layout="paged", page_pool_pages=pool)
    for r in _trace(Request):
        eng.add_request(r)
    got = {}
    while eng.has_unfinished():
        got.update({ev.output.id: ev.output for ev in eng.step()
                    if ev.finished})
        owner_free, table_free = eng.page_accounting()
        assert owner_free == table_free
    _same(dense_run, got)
    assert eng.page_accounting() == (pool, pool)
    stats = eng.page_pool_stats()
    assert stats["peak_occupancy"] == 1.0
    assert stats["preemptions"] + stats["stall_rounds"] > 0


def test_paged_engine_mixed_max_tokens_match_solo(params):
    eng = _engine(params, cache_layout="paged", page_pool_pages=TIGHT)
    mixed = [Request(prompt=p, id=i, max_tokens=B if i < 2 else None)
             for i, p in enumerate(_prompts())]
    got = {o.id: o for o in eng.generate(mixed)}
    for req in mixed:
        solo = eng.generate([Request(prompt=req.prompt, id=req.id,
                                     max_tokens=req.max_tokens)])[0]
        np.testing.assert_array_equal(solo.tokens, got[req.id].tokens)
        assert solo.steps == got[req.id].steps


def test_stream_no_duplicate_blocks_under_preemption(params, dense_run):
    eng = _engine(params, cache_layout="paged", page_pool_pages=TIGHT)
    seen, blocks, outs = set(), {}, {}
    for ev in eng.stream(_trace(Request)):
        assert (ev.request_id, ev.index) not in seen
        seen.add((ev.request_id, ev.index))
        assert ev.index == len(blocks.setdefault(ev.request_id, []))
        blocks[ev.request_id].append(ev.tokens)
        if ev.finished:
            outs[ev.request_id] = ev.output
    assert eng.page_pool_stats()["preemptions"] >= 1
    _same(dense_run, outs)
    for rid, out in outs.items():
        span = np.concatenate(blocks[rid])
        np.testing.assert_array_equal(span[:len(out.tokens)], out.tokens)


def test_abort_returns_the_lanes_pages(params):
    eng = _engine(params, cache_layout="paged", page_pool_pages=TIGHT)
    for r in _trace(Request)[:3]:
        eng.add_request(r)
    eng.step()
    lane, rid = next((i, f.req.id) for i, f in enumerate(eng._flights)
                     if f is not None)
    held = int((eng._state.cache.page_table[lane] != C.FREE).sum())
    free_before = eng.page_accounting()[0]
    assert held > 0 and eng.abort(rid)
    assert eng.page_accounting() == (free_before + held,) * 2
    while eng.has_unfinished():
        eng.step()
    assert eng.page_accounting() == (TIGHT, TIGHT)


def test_pool_sizing_errors(params):
    with pytest.raises(ValueError, match="deadlock-free minimum"):
        _engine(params, cache_layout="paged", page_pool_pages=T // B - 1)
    with pytest.raises(ValueError, match="page_pool_pages"):
        _engine(params, page_pool_pages=12)
    with pytest.raises(ValueError, match="cache layout"):
        _engine(params, cache_layout="bogus")
    assert _engine(params).page_pool_stats()["n_pages"] == 0.0


def test_serve_cli_paged_prints_the_pool_line(capsys):
    from repro_torch.launch import serve
    serve.main(["--reduced", "--device", "cpu", "--prompt-len", "8",
                "--gen-length", "8", "--block-size", "4", "--requests", "3",
                "--batch", "2", "--cache-layout", "paged", "--pool-pages",
                "4", "--scheduler", "continuous"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2].startswith("cdlm/continuous: TPS=")
    assert lines[-1].startswith("page pool: ") and "/4 pages" in lines[-1]
