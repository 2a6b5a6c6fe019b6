"""The static engine's device state for the CUDA graphs of its decode, on
the CPU: every buffer of its ``DecodeState`` (canvases, the cache in each
policy's layout, the scalar key, ``done``, ``steps``, ``active``, the
per-lane params, the block's start, the AR step's position and logits)
keeps its address across warmup, step, generate, abort and a second
generate, for each of the six decoders; every step the engine would
capture (each threshold iteration variant, the prefill, the refresh, the
commit forward, the AR step, ``vanilla``'s canvas forward) reads nothing
from the host; a batch after another on the same engine decodes as a
fresh engine does; and a graph is refused off CUDA. The graphs themselves
run only on a card (``tests/test_torch_cuda.py``); the engine they replay
is held against the JAX engine by ``tests/test_torch_decoders.py`` and
``tests/test_torch_sampling.py``."""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.bridge import init_params  # noqa: E402
from repro_torch.configs import ServeConfig, get_config  # noqa: E402
from repro_torch.core import cache as C  # noqa: E402
from repro_torch.core.sampler import SAMPLERS  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    Engine,
    Request,
    SamplingParams,
    make_engine,
)

torch.set_num_threads(2)

CFG = get_config("qwen2-0.5b").reduced(dtype="float32")
P, G, B = 8, 16, 4
THRESHOLD = ("fast_dllm", "dual_cache", "interval_cache", "cdlm")
# every decoder, and cdlm on the paged layout too
ENGINES = [(name, "dense") for name in SAMPLERS] + [("cdlm", "paged")]
ENGINE_IDS = [f"{n}-{layout}" for n, layout in ENGINES]


@pytest.fixture(scope="module")
def params():
    p = init_params(CFG, torch.Generator().manual_seed(0), "cpu")
    p["embed"]["tok"] *= 40.0      # a sharp head: iterations finalize >1
    p["embed"]["tok"][CFG.mask_token_id] = 0.0
    p["embed"]["tok"][CFG.eos_token_id] *= 3.0   # some lanes stop early
    return p


def _engine(params, name, layout="dense", **kw):
    serve = ServeConfig(**dict(dict(
        max_batch=3, block_size=B, gen_length=G, conf_threshold=0.5,
        cache_refresh_interval=2, scheduler="static", sampler=name,
        cache_layout=layout), **kw))
    return Engine(params, CFG, serve, prompt_len=P, device="cpu")


def _prompts(n, seed=0):
    return np.random.default_rng(seed).integers(2, CFG.vocab_size - 1,
                                                (n, P), dtype=np.int64)


def _trace(name, n=5, seed=0, first_id=0, per_request=True):
    """Bare requests, or for a threshold decoder (``per_request``) greedy,
    sampled and bare ones with mixed caps and thresholds."""
    prompts = _prompts(n, seed)
    sps = [None] * n
    caps = [None] * n
    if per_request and name in THRESHOLD:
        sps = [None, SamplingParams(temperature=0.8, seed=3),
               SamplingParams(conf_threshold=0.3),
               SamplingParams(temperature=1.2, seed=9), None][:n]
        caps = [None, 2 * B, None, None, B][:n]
    return [Request(prompt=p, id=first_id + i, max_tokens=c, params=sp)
            for i, (p, c, sp) in enumerate(zip(prompts, caps, sps))]


def _addresses(eng):
    """data_ptr of every buffer of the engine's decode state."""
    st = eng._state
    out = {name: getattr(st, name).data_ptr()
           for name in ("tokens", "key", "done", "steps", "active", "start",
                        "pos")}
    if st.last is not None:
        out["last"] = st.last.data_ptr()
    for name, buf in st.lanes._asdict().items():
        out[f"lanes.{name}"] = buf.data_ptr()
    for i, buf in enumerate(st.cache_buffers()):
        out[f"cache{i}"] = buf.data_ptr()
    if isinstance(st.cache, C.PagedCache):
        out["table"] = st.cache.device_table().data_ptr()
    return out


def _outputs(outs):
    return {o.id: (o.tokens.tolist(), o.steps, o.gen_length,
                   o.finish_reason) for o in outs}


@pytest.mark.parametrize("name,layout", ENGINES, ids=ENGINE_IDS)
def test_static_state_keeps_its_addresses(params, name, layout):
    eng = _engine(params, name, layout)
    want = _addresses(eng)
    eng.warmup(per_request=True)
    assert _addresses(eng) == want
    first = _outputs(eng.generate(_trace(name)))
    assert _addresses(eng) == want
    # step by step: a batch, an abort of a queued request, the rest
    for r in _trace(name, first_id=10):
        eng.add_request(r)
    assert eng.step()
    assert _addresses(eng) == want
    assert eng.abort(14)
    while eng.has_unfinished():
        eng.step()
        assert _addresses(eng) == want
    # a second generate() on the same buffers decodes as the first
    assert _outputs(eng.generate(_trace(name))) == first
    assert _addresses(eng) == want


_REFUSED = ("cpu", "numpy", "item", "tolist", "__bool__", "__int__",
            "__float__")


@contextlib.contextmanager
def _no_host_reads(monkeypatch):
    """Inside: no upload of host data and no read back to the host."""
    as_tensor = torch.as_tensor

    def refuse(*_, **__):
        raise AssertionError("host read or upload inside a captured step")

    def as_tensor_of_tensors(data, *a, **kw):
        if not isinstance(data, torch.Tensor):
            raise AssertionError(f"torch.as_tensor of {type(data)} inside "
                                 "a captured step")
        return as_tensor(data, *a, **kw)

    with monkeypatch.context() as m:
        m.setattr(torch, "as_tensor", as_tensor_of_tensors)
        m.setattr(torch, "from_numpy", refuse)
        m.setattr(torch, "tensor", refuse)
        for attr in _REFUSED:
            m.setattr(torch.Tensor, attr, refuse)
        yield


# the steps each decoder's engine captures, by case
CAPTURED = {"vanilla": {"canvas"}, "fast_dllm": set(),
            "dual_cache": {"refresh"}, "interval_cache": {"refresh"},
            "cdlm": {"prefill", "commit"}, "ar": {"prefill", "step"}}
CASES = [(n, layout, case) for n, layout in ENGINES
         for case in (("fused", "dense", "sampled", "lanes")
                      if n in THRESHOLD else ("fused", "dense", "sampled")
                      if n == "vanilla" else ("fused",))]


@pytest.mark.parametrize("name,layout,case", CASES,
                         ids=[f"{n}-{lay}-{c}" for n, lay, c in CASES])
def test_captured_steps_read_nothing_from_the_host(params, name, layout,
                                                   case, monkeypatch):
    """Every callable the engine hands its replay hook runs on device
    state alone: the hook here runs it eagerly with every upload and read
    back refused. The steps are the ones each decoder's graphs capture:
    the iteration variant of the case (the scalar path greedy through
    fused select or dense logits, sampled; the per-lane path greedy and
    with sampled lanes) and the decoder's host-scheduled forwards."""
    kw = {"fused": dict(fused_select=True), "dense": {},
          "sampled": dict(temperature=0.7), "lanes": {}}[case]
    eng = _engine(params, name, layout, **kw)
    seen = []

    def hook(step, fn):
        seen.append(step)
        with _no_host_reads(monkeypatch):
            return fn()

    eng._replay = hook
    reqs = _trace(name, n=3, per_request=case == "lanes")
    if case == "lanes":
        # a batch of per-lane greedy params, then one with sampled lanes
        for r in reqs[:2]:
            r.params = SamplingParams(conf_threshold=0.3)
        reqs += _trace(name, n=3, seed=1, first_id=3)
    outs = eng.generate(reqs)
    assert sorted(o.id for o in outs) == list(range(len(reqs)))
    want = set(CAPTURED[name])
    if name in THRESHOLD:
        want |= ({"lanes", "lanes-sampled"} if case == "lanes"
                 else {"sampled" if case == "sampled" else "greedy"})
    assert set(seen) == want
    # the loop still runs: real tokens before any EOS
    for o in outs:
        assert not np.any(o.tokens[:o.gen_length] == CFG.mask_token_id)


SHORT_CASES = [(n, lay, c) for n, lay in ENGINES
               for c in (("greedy", "sampled", "lanes")
                         if n in THRESHOLD else ("greedy", "sampled")
                         if n == "vanilla" else ("greedy",))]


@pytest.mark.parametrize("name,layout,case", SHORT_CASES,
                         ids=[f"{n}-{lay}-{c}" for n, lay, c in SHORT_CASES])
def test_a_short_batch_after_a_long_one_decodes_as_fresh(params, name, layout,
                                                         case):
    """A full batch, then one padded request on the same engine: the second
    equals a fresh engine's decode of it (no state left from the first:
    canvases, cache rows past the prompt, done, steps, keys)."""
    kw = dict(temperature=0.7) if case == "sampled" else {}
    per_request = case == "lanes"
    eng = _engine(params, name, layout, **kw)
    long = _trace(name, n=3, seed=1, per_request=per_request)
    short = _trace(name, n=4, seed=2, per_request=per_request)[1:2]
    eng.generate(long)
    got = _outputs(eng.generate(short))
    fresh = _outputs(_engine(params, name, layout, **kw).generate(short))
    assert got == fresh
    # and the long batch again equals its first decode
    again = _engine(params, name, layout, **kw)
    assert _outputs(again.generate(long)) == _outputs(eng.generate(long))


def test_static_graphs_need_cuda(params):
    serve = ServeConfig(max_batch=2, block_size=B, gen_length=G,
                        scheduler="static")
    with pytest.raises(ValueError, match="graphs=True"):
        Engine(params, CFG, serve, prompt_len=P, device="cpu", graphs=True)
    with pytest.raises(ValueError, match="graphs=True"):
        make_engine(params, CFG, serve, prompt_len=P, device="cpu",
                    graphs=True)
    for graphs in (None, False):
        eng = make_engine(params, CFG, serve, prompt_len=P, device="cpu",
                          graphs=graphs)
        assert isinstance(eng, Engine) and not eng.graphed
