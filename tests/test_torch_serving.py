"""The port's ContinuousEngine against the JAX package's, on one request
trace and one set of params: identical tokens, steps, gen_length and
finish_reason per request, and the same number of forward passes. Then the
port's own serving invariants: mid-flight eviction is exact, max_tokens
caps, abort, stream reassembly, the greedy-only rule of a fused_select
engine, the dense-logits decode against the JAX engine, and device
rules."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.base import ServeConfig as JaxServeConfig  # noqa: E402
from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.models import init_model  # noqa: E402
from repro.serving import ContinuousEngine as JaxEngine  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import SamplingParams as JaxSamplingParams  # noqa: E402
from repro_torch.bridge import init_params, params_from_jax  # noqa: E402
from repro_torch.configs import ServeConfig, get_config  # noqa: E402
from repro_torch.models import forward  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    ContinuousEngine,
    Request,
    SamplingParams,
)

torch.set_num_threads(2)

JCFG = jax_get_config("qwen2-0.5b").reduced(dtype="float32")
CFG = get_config("qwen2-0.5b").reduced(dtype="float32")
P, G, B = 8, 16, 4
TAU = 0.5
EMBED_SCALE = 40.0   # sharpens the tied head so some iterations finalize >1


def _serve(cls, max_batch=2):
    return cls(max_batch=max_batch, block_size=B, gen_length=G,
               conf_threshold=TAU, scheduler="continuous", fused_select=True)


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


def _trace(cls, sp_cls):
    """6 requests through 2 lanes: mixed max_tokens (lanes are evicted and
    refilled mid-flight), one per-request threshold, one EOS override."""
    rng = np.random.default_rng(0)
    prompts = rng.integers(2, CFG.vocab_size - 1, (6, P), dtype=np.int32)
    caps = [B, None, 2 * B, None, B, 3 * B]
    params = [None, sp_cls(conf_threshold=0.3), None, None,
              sp_cls(eos_token_id=7), None]
    return [cls(prompt=p, id=i, max_tokens=c, params=sp)
            for i, (p, c, sp) in enumerate(zip(prompts, caps, params))]


@pytest.fixture(scope="module")
def jax_run(tree):
    eng = JaxEngine(jax.tree_util.tree_map(jax.numpy.asarray, tree), JCFG,
                    _serve(JaxServeConfig), prompt_len=P)
    outs = {o.id: o for o in eng.generate(_trace(JaxRequest,
                                                 JaxSamplingParams))}
    return outs, int(eng._state.calls)


def _by_id(outputs):
    return {o.id: o for o in outputs}


def test_trace_matches_jax_engine(params, jax_run):
    want, want_calls = jax_run
    eng = ContinuousEngine(params, CFG, _serve(ServeConfig), prompt_len=P,
                           device="cpu")
    got = _by_id(eng.generate(_trace(Request, SamplingParams)))
    assert sorted(got) == sorted(want)
    for rid, w in want.items():
        g = got[rid]
        np.testing.assert_array_equal(g.tokens, np.asarray(w.tokens), rid)
        assert (g.steps, g.gen_length, g.finish_reason) == \
            (w.steps, w.gen_length, w.finish_reason), rid
    assert eng.call_counts()["total"] == want_calls
    # some refinement iteration finalized more than one token
    decoded = {r.id: B * (-(-(r.max_tokens or G) // B))
               for r in _trace(Request, SamplingParams)}
    assert any(w.steps < decoded[rid] for rid, w in want.items())


def _engine(params, max_batch=2):
    return ContinuousEngine(params, CFG, _serve(ServeConfig, max_batch),
                            prompt_len=P, device="cpu")


def test_mid_flight_eviction_is_exact(params):
    """A request admitted into a recycled lane decodes exactly as alone."""
    eng = _engine(params)
    mixed = _trace(Request, SamplingParams)
    batched = _by_id(eng.generate(mixed))
    for req in mixed:
        solo = eng.generate([Request(prompt=req.prompt, id=req.id,
                                     max_tokens=req.max_tokens,
                                     params=req.params)])[0]
        got = batched[req.id]
        np.testing.assert_array_equal(solo.tokens, got.tokens, req.id)
        assert (solo.steps, solo.gen_length) == (got.steps, got.gen_length)


def test_max_tokens_caps_generation(params):
    prompt = _trace(Request, SamplingParams)[0].prompt
    out = _engine(params).generate([Request(prompt=prompt, id=0,
                                            max_tokens=B)])[0]
    assert out.gen_length <= B and out.tokens.shape == (B,)


def test_abort_frees_lane_without_perturbing_others(params):
    reqs = _trace(Request, SamplingParams)[:3]
    eng = _engine(params)
    solo = {r.id: _engine(params).generate([Request(
        prompt=r.prompt, id=r.id, max_tokens=r.max_tokens,
        params=r.params)])[0] for r in reqs}
    for r in reqs:
        eng.add_request(Request(prompt=r.prompt, id=r.id,
                                max_tokens=r.max_tokens, params=r.params))
    eng.step()                  # requests 0 and 1 decode, request 2 waits
    assert eng.abort(1)         # in flight: its lane is freed for request 2
    assert not eng.abort(99)
    outs = {}
    while eng.has_unfinished():
        outs.update({ev.output.id: ev.output for ev in eng.step()
                     if ev.finished})
    assert 1 not in outs
    for rid, out in outs.items():
        np.testing.assert_array_equal(out.tokens, solo[rid].tokens)
        assert out.steps == solo[rid].steps


def test_stream_reassembles_to_generate(params):
    reqs = _trace(Request, SamplingParams)
    eng = _engine(params)
    final = _by_id(eng.generate(reqs))
    blocks = {}
    for ev in eng.stream([Request(prompt=r.prompt, id=r.id,
                                  max_tokens=r.max_tokens, params=r.params)
                          for r in reqs]):
        blocks.setdefault(ev.request_id, []).append((ev.index, ev.tokens))
    for rid, out in final.items():
        span = np.concatenate([t for _, t in sorted(blocks[rid],
                                                    key=lambda x: x[0])])
        n = len(out.tokens)
        np.testing.assert_array_equal(span[:n], out.tokens)


def test_sampled_requests_are_refused(params):
    """The JAX package's rule: a ``fused_select`` engine is greedy-only. It
    refuses a per-request temperature > 0 at ``add_request`` and a sampled
    engine default at construction; an engine without ``fused_select``
    (the default ``ServeConfig``) takes both."""
    eng = _engine(params)
    with pytest.raises(ValueError, match="greedy requests only"):
        eng.add_request(Request(prompt=np.zeros(P, np.int32),
                                params=SamplingParams(temperature=0.7)))
    with pytest.raises(ValueError, match="greedy-only"):
        ContinuousEngine(params, CFG, ServeConfig(temperature=0.5,
                                                  fused_select=True),
                         prompt_len=P, device="cpu")
    dense = ContinuousEngine(params, CFG, ServeConfig(), prompt_len=P,
                             device="cpu")
    dense.add_request(Request(prompt=np.zeros(P, np.int32),
                              params=SamplingParams(temperature=0.7)))
    ContinuousEngine(params, CFG, ServeConfig(temperature=0.5), prompt_len=P,
                     device="cpu")


def test_engine_decodes_through_the_fused_select_only(params, tree):
    """With ``fused_select=False`` the engine decodes greedily through the
    dense logits, as the JAX engine does with the same setting: the trace
    gives the JAX engine's tokens, steps, gen_length, finish_reason and
    call count."""
    def serve(cls):
        return cls(max_batch=2, block_size=B, gen_length=G,
                   conf_threshold=TAU, scheduler="continuous",
                   fused_select=False)
    jeng = JaxEngine(jax.tree_util.tree_map(jax.numpy.asarray, tree), JCFG,
                     serve(JaxServeConfig), prompt_len=P)
    want = _by_id(jeng.generate(_trace(JaxRequest, JaxSamplingParams)))
    eng = ContinuousEngine(params, CFG, serve(ServeConfig), prompt_len=P,
                           device="cpu")
    got = _by_id(eng.generate(_trace(Request, SamplingParams)))
    assert sorted(got) == sorted(want)
    for rid, w in want.items():
        np.testing.assert_array_equal(got[rid].tokens, np.asarray(w.tokens),
                                      rid)
        assert (got[rid].steps, got[rid].gen_length,
                got[rid].finish_reason) == (w.steps, w.gen_length,
                                            w.finish_reason), rid
    assert eng.call_counts()["total"] == int(jeng._state.calls)


def test_entry_points_need_cuda_unless_asked_for_cpu(params):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ContinuousEngine(params, CFG, _serve(ServeConfig), prompt_len=P)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(CFG, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        forward(params, np.zeros((1, 4), np.int64), cfg=CFG)


def test_selection_rules_match_jax():
    """Threshold / top-k finalization (first-occurrence ties, per-lane tau,
    finalized rows) and the generation length against the JAX package."""
    from repro.core import diffusion as jax_d
    from repro.core.block_loop import SamplerSpec as JaxSpec
    from repro.core.block_loop import _gen_lengths as jax_gen_lengths
    from repro_torch.core import diffusion as D
    from repro_torch.core.block_loop import SamplerSpec as Spec
    from repro_torch.core.block_loop import _gen_lengths
    conf = np.array([[0.2, 0.5, 0.5, 0.1, 0.5, 0.3],      # three-way tie
                     [-np.inf] * 6,                      # block finalized
                     [0.9, -np.inf, 0.95, 0.2, 0.95, 0.4]], np.float32)
    block = np.array([[True] * 6])
    tau = np.array([[0.6], [0.5], [0.9]], np.float32)
    jc, tc = jax.numpy.asarray(conf), torch.as_tensor(conf)
    for k in (1, 2, 3):
        np.testing.assert_array_equal(
            D.select_topk_in_block(tc, torch.as_tensor(block), k).numpy(),
            np.asarray(jax_d.select_topk_in_block(jc, block, k)))
    np.testing.assert_array_equal(
        D.select_threshold_in_block(tc, torch.as_tensor(block),
                                    torch.as_tensor(tau)).numpy(),
        np.asarray(jax_d.select_threshold_in_block(jc, block, tau)))
    logits = np.random.default_rng(0).normal(0, 1, (3, 6, 9)).astype(
        np.float32)
    logits[0, 0, [2, 5]] = 9.0                            # argmax tie
    tokens = np.array([[511, 3, 511, 511, 4, 511]] * 3)
    got = D.confidence_and_candidates(torch.as_tensor(logits),
                                      torch.as_tensor(tokens), 511)
    want = jax_d.confidence_and_candidates(jax.numpy.asarray(logits),
                                           jax.numpy.asarray(tokens), 511)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-6)
    canvas = np.array([[9, 9, 5, 1, 1, 3], [9, 9, 2, 2, 2, 2],
                       [9, 9, 7, 7, 7, 7]])
    eos = np.array([1, 2, 1])
    np.testing.assert_array_equal(
        _gen_lengths(torch.as_tensor(canvas), Spec(2, 4, 2), CFG,
                     eos_id=torch.as_tensor(eos)).numpy(),
        np.asarray(jax_gen_lengths(jax.numpy.asarray(canvas),
                                   JaxSpec(2, 4, 2), JCFG,
                                   eos_id=jax.numpy.asarray(eos))))


def test_serve_cli_runs_on_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--reduced", "--device", "cpu", "--prompt-len", "8",
                "--gen-length", "8", "--block-size", "4", "--requests", "3",
                "--batch", "2", "--fused-select", "--scheduler",
                "continuous"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("cdlm/continuous: TPS=") and "gen_len=" in line
