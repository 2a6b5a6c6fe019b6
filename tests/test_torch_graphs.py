"""The continuous engine's device state for the CUDA graphs of its block
decode, on the CPU: every static buffer (canvases, the dense cache or the
paged pools, the device page table, the per-lane ``starts``, ``live``,
``taus``, ``temps``, ``keys`` and ``active``) keeps its address across warmup, admission,
eviction, abort, preemption and successive ``generate()`` calls; the
refinement iteration (each of its variants) and the commit forward, the
captured callables, read nothing from the host; and a graph is refused off CUDA. The graphs
themselves run only on a card (``tests/test_torch_cuda.py``); the parity of
the engine that the graphs replay is held against the JAX engine by
``tests/test_torch_serving.py`` and ``tests/test_torch_paged.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.bridge import init_params  # noqa: E402
from repro_torch.configs import ServeConfig, get_config  # noqa: E402
from repro_torch.core import cache as C  # noqa: E402
from repro_torch.core.block_loop import SamplerSpec, _top1_loop  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    ContinuousEngine,
    Request,
    SamplingParams,
)

torch.set_num_threads(2)

CFG = get_config("qwen2-0.5b").reduced(dtype="float32")
P, G, B = 8, 16, 4
T = P + G
TIGHT = T // B + 2          # too small for two full canvases: stalls
LAYOUTS = {"dense": {}, "paged": {"cache_layout": "paged",
                                  "page_pool_pages": TIGHT}}


@pytest.fixture(scope="module")
def params():
    p = init_params(CFG, torch.Generator().manual_seed(0), "cpu")
    p["embed"]["tok"] *= 40.0      # a sharp head: iterations finalize >1
    p["embed"]["tok"][CFG.mask_token_id] = 0.0
    return p


def _engine(params, layout):
    serve = ServeConfig(max_batch=2, block_size=B, gen_length=G,
                        conf_threshold=0.5, scheduler="continuous",
                        fused_select=True, **LAYOUTS[layout])
    return ContinuousEngine(params, CFG, serve, prompt_len=P, device="cpu")


def _trace(first_id=0):
    """5 requests through 2 lanes with mixed max_tokens: lanes are evicted
    and refilled mid-flight."""
    prompts = np.random.default_rng(0).integers(2, CFG.vocab_size - 1,
                                                (5, P), dtype=np.int32)
    caps = [None, B, None, 2 * B, None]
    return [Request(prompt=p, id=first_id + i, max_tokens=c)
            for i, (p, c) in enumerate(zip(prompts, caps))]


def _addresses(eng):
    """data_ptr of every buffer the graphs read or write."""
    st = eng._state
    out = {"tokens": st.tokens.data_ptr(), "starts": st.starts_t.data_ptr(),
           "live": st.live_t.data_ptr(), "taus": st.taus_t.data_ptr(),
           "active": st.active_t.data_ptr(), "temps": st.temps_t.data_ptr(),
           "keys": st.keys_t.data_ptr()}
    if eng.paged:
        slots = st.cache.slots
        out["table"] = st.cache.device_table().data_ptr()
    else:
        slots = st.cache
    for i, slot in enumerate(slots):
        for key, buf in slot.items():
            out[f"cache{i}.{key}"] = buf.data_ptr()
    return out


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_engine_state_keeps_its_addresses(params, layout):
    eng = _engine(params, layout)
    want = _addresses(eng)
    eng.warmup()
    assert _addresses(eng) == want
    first = {o.id: o for o in eng.generate(_trace())}
    assert _addresses(eng) == want
    if eng.paged:
        assert eng.page_pool_stats()["preemptions"] >= 1
        assert eng.page_accounting() == (TIGHT, TIGHT)
    # step by step: admission, an abort of an in-flight lane, evictions
    for r in _trace(first_id=10):
        eng.add_request(r)
    eng.step()
    assert _addresses(eng) == want
    rid = next(f.req.id for f in eng._flights if f is not None)
    assert eng.abort(rid)
    assert _addresses(eng) == want
    while eng.has_unfinished():
        eng.step()
        assert _addresses(eng) == want
    # a second generate() on the same buffers decodes as the first
    again = {o.id: o for o in eng.generate(_trace())}
    assert _addresses(eng) == want
    for rid, o in first.items():
        np.testing.assert_array_equal(again[rid].tokens, o.tokens)
        assert again[rid].steps == o.steps


def _refuse(*_, **__):
    raise AssertionError("host read inside a captured step")


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_captured_steps_read_nothing_from_the_host(params, layout,
                                                   monkeypatch):
    """The refinement iteration and the commit forward run on device state
    alone: no numpy upload, no read back (the block's inputs are written
    before the first replay)."""
    eng = _engine(params, layout)
    for r in _trace()[::2][:2]:             # two requests of G tokens
        eng.add_request(r)
    eng.step()                              # both lanes now at block 1
    st = eng._state
    live = st.live.copy()
    assert live.all()
    eng._write_block_inputs(st, P + st.blk * B, live)
    before = st.tokens.clone()
    as_tensor = torch.as_tensor

    def as_tensor_of_tensors(data, *a, **kw):
        if not isinstance(data, torch.Tensor):
            raise AssertionError(f"torch.as_tensor of {type(data)} inside "
                                 "a captured step")
        return as_tensor(data, *a, **kw)

    with monkeypatch.context() as m:
        m.setattr(torch, "as_tensor", as_tensor_of_tensors)
        m.setattr(torch, "from_numpy", _refuse)
        for name in ("cpu", "numpy", "item", "tolist", "__bool__",
                     "__int__", "__float__"):
            m.setattr(torch.Tensor, name, _refuse)
        eng._refine()
        emissions = eng._commit_forward()
    changed = (st.tokens != before).any(-1)
    assert changed.all()                    # every live lane finalized some
    assert not (st.tokens[:, :P] != before[:, :P]).any()
    assert emissions[0]["k"].shape == (CFG.n_periods, 2, B, CFG.n_kv_heads,
                                       CFG.head_dim)


@pytest.mark.parametrize("variant", ["dense", "sampled"])
def test_every_iteration_variant_reads_nothing_from_the_host(
        params, variant, monkeypatch):
    """The dense-logits greedy and the sampled iterations (an engine
    without fused select, a greedy and a sampled lane) run on device state
    alone too; the sampled one advances the active lanes' keys in
    place."""
    serve = ServeConfig(max_batch=2, block_size=B, gen_length=G,
                        conf_threshold=0.5, scheduler="continuous")
    eng = ContinuousEngine(params, CFG, serve, prompt_len=P, device="cpu")
    sps = [None, SamplingParams(temperature=0.8, seed=4)]
    for r, sp in zip(_trace()[::2][:2], sps):
        r.params = sp
        eng.add_request(r)
    eng.step()
    st = eng._state
    eng._write_block_inputs(st, P + st.blk * B, st.live.copy())
    before, keys = st.tokens.clone(), st.keys_t.clone()
    with monkeypatch.context() as m:
        m.setattr(torch, "from_numpy", _refuse)
        for name in ("cpu", "numpy", "item", "tolist", "__bool__",
                     "__int__", "__float__"):
            m.setattr(torch.Tensor, name, _refuse)
        eng._refine(variant)
    assert (st.tokens != before).any(-1).all()
    assert torch.equal(st.keys_t != keys,
                       torch.full_like(keys, variant == "sampled",
                                       dtype=torch.bool))


def test_graphs_need_cuda(params):
    serve = ServeConfig(max_batch=2, block_size=B, gen_length=G,
                        scheduler="continuous", fused_select=True)
    with pytest.raises(ValueError, match="graphs=True"):
        ContinuousEngine(params, CFG, serve, prompt_len=P, device="cpu",
                         graphs=True)
    assert not ContinuousEngine(params, CFG, serve, prompt_len=P,
                                device="cpu").graphed
    spec = SamplerSpec(prompt_len=P, gen_len=B, block_size=B,
                       fused_select=True)
    with pytest.raises(ValueError, match="graphs=True"):
        _top1_loop(params, torch.zeros((1, P), dtype=torch.int64), cfg=CFG,
                   spec=spec, record_hidden=False, graphs=True)


def test_warmup_refused_while_a_request_is_in_flight(params):
    eng = _engine(params, "dense")
    for r in _trace()[:2]:
        eng.add_request(r)
    eng.warmup()                            # queued requests are not lanes
    eng.step()
    with pytest.raises(RuntimeError, match="busy"):
        eng.warmup()
    while eng.has_unfinished():
        eng.step()
    eng.warmup()
    assert eng.call_counts()["total"] == 0


def test_device_table_keeps_its_address():
    tc = C.init_paged_cache(CFG, 2, T, n_pages=6, page_size=B, device="cpu")
    table = tc.device_table()
    ptr = table.data_ptr()
    C.alloc(tc, np.array([True, True]), 0, 2 * B)
    assert tc.device_table() is table and table.data_ptr() == ptr
    np.testing.assert_array_equal(table.numpy(), tc.page_table)
    C.free(tc, np.array([True, False]))
    assert tc.device_table() is table
    np.testing.assert_array_equal(table.numpy(), tc.page_table)
