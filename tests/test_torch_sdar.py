"""sdar-30b-a3b (Qwen3-MoE layers: QK-norm, 128 experts of which every
token's top 8 are computed) at ``reduced()`` size in fp32 on the CPU,
against the plain reference the benchmark judges it by
(``bench/reference/moe_decoder.py``, loaded by path): full-sequence logits,
the admission prefill with cached block forwards, the continuous engine
dense == paged, a planted imbalance that the capacity path would drop and
the grouped dispatch does not, QK-norm on and off; the grouped product's
plain version against every expert on every token; and the serve CLI."""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ServeConfig  # noqa: E402
from repro_torch.core import cache as C  # noqa: E402
from repro_torch.core import masks  # noqa: E402
from repro_torch.core.block_loop import SamplerSpec, lane_block_forward  # noqa: E402,E501
from repro_torch.kernels.moe import grouped_experts  # noqa: E402
from repro_torch.kernels.moe import ref as mref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import forward  # noqa: E402
from repro_torch.models import moe as MO  # noqa: E402
from repro_torch.serving import ContinuousEngine, Request  # noqa: E402
from repro_torch.serving.server import EngineDriver  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT / "bench") not in sys.path:
    sys.path.insert(0, str(ROOT / "bench"))
from harness import cell as CL  # noqa: E402
from harness import spec as SP  # noqa: E402
from harness import weights as WT  # noqa: E402

torch.set_num_threads(2)
P, B, NB = 12, 4, 3            # prompt, block, blocks
TOL = 1e-5                     # fp32 sums in another order


def _model(**kw):
    cfg = dataclasses.replace(get_config("sdar-30b-a3b").reduced(), **kw)
    return cfg, dataclasses.asdict(cfg)


REF = SP.load_module(ROOT, "reference", "moe_decoder")


def _params(model, seed=3, zero_router=False):
    params = WT.draw(REF.layout(model), model, seed, torch.device("cpu"),
                     torch.float32)
    if zero_router:   # every token's router ties: experts 0..k-1 win
        params["slots"][0]["moe"]["router"].zero_()
    return params


def _sequence(seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 500, P), rng.integers(0, 500, (NB, B))


def _ref_logits(params, model, prompt, blocks):
    """The reference's logits of every generated position, (NB, B, V): the
    blocks as states, each over the prompt and the blocks before it."""
    V = model["vocab_size"]
    got = REF.block_stats(params, model, [{
        "prompt": prompt, "context": blocks[:-1].reshape(-1),
        "states": blocks, "state_block": np.arange(NB)}],
        gather=[np.broadcast_to(np.arange(V), (NB, B, V)).copy()])[0]
    return torch.as_tensor(got["gathered"])


def _full_logits(params, cfg, prompt, blocks):
    toks = torch.as_tensor(np.concatenate([prompt, blocks.reshape(-1)]))
    out = forward(params, toks[None], cfg=cfg, device="cpu",
                  mode=masks.BLOCK_CAUSAL, prompt_len=P, block_size=B)
    return out.logits[0, P:].reshape(NB, B, -1)


def _cached_logits(params, cfg, prompt, blocks, paged: bool):
    """The engines' path: the prompt's prefill committed into the cache,
    then each block's cached forward (lane_block_forward), its emissions
    committed before the next."""
    toks = torch.as_tensor(np.concatenate([prompt, blocks.reshape(-1)]))[None]
    T = P + NB * B
    cache = (C.init_paged_cache(cfg, 1, T, n_pages=-(-T // B), page_size=B,
                                device="cpu") if paged
             else C.init_cache(cfg, 1, T, device="cpu"))
    if paged:
        C.alloc(cache, np.ones(1, bool), 0, T)
    pre = forward(params, toks[:, :P], cfg=cfg, device="cpu",
                  mode=masks.BLOCK_CAUSAL, prompt_len=P, block_size=B,
                  return_logits=False)
    C.commit_rows(cache, pre.emissions, 0, np.ones(1, bool))
    spec = SamplerSpec(prompt_len=P, gen_len=NB * B, block_size=B)
    out = []
    for b in range(NB):
        logits, em = lane_block_forward(
            params, toks, torch.tensor([P + b * B]), cache, cfg=cfg,
            spec=spec, decode_attention_fn=None,
            paged_decode_attention_fn=None, elementwise_fns=None,
            moe_per_row=True)
        C.commit_rows(cache, em, P + b * B, np.ones(1, bool))
        out.append(logits[0])
    return torch.stack(out)


def test_full_sequence_logits_match_the_reference():
    cfg, model = _model()
    params = _params(model)
    prompt, blocks = _sequence()
    got = _full_logits(params, cfg, prompt, blocks)
    want = _ref_logits(params, model, prompt, blocks)
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_prefill_and_cached_blocks_match_the_reference(paged):
    cfg, model = _model()
    params = _params(model, seed=4)
    prompt, blocks = _sequence(1)
    got = _cached_logits(params, cfg, prompt, blocks, paged)
    want = _ref_logits(params, model, prompt, blocks)
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


def test_continuous_engine_dense_equals_paged():
    """Tokens, steps and the grouped MoE's tally agree across layouts; the
    tally counts every choice of every token of every MoE forward, and
    ``/metrics`` exports it."""
    cfg, _ = _model()
    params = _params(dataclasses.asdict(cfg), seed=5)
    prompts = np.random.default_rng(2).integers(2, 500, (3, 16))
    runs = {}
    for layout in ("dense", "paged"):
        serve_cfg = ServeConfig(max_batch=2, block_size=8, gen_length=16,
                                scheduler="continuous", cache_layout=layout,
                                fused_select=True)
        eng = ContinuousEngine(params, cfg, serve_cfg, 16, device="cpu")
        outs = eng.generate([Request(prompt=p, id=i)
                             for i, p in enumerate(prompts)])
        calls, stats = eng.call_counts(), eng.moe_stats()
        forwards_tokens = (calls["admit"] * 2 * 16
                           + (calls["refine"] + calls["commit"]) * 2 * 8)
        assert stats["pairs_total"] == (forwards_tokens * cfg.n_layers
                                        * cfg.experts_per_token)
        assert stats["rows_padded_total"] >= stats["pairs_total"]
        runs[layout] = {o.id: (o.tokens.tolist(), o.steps) for o in outs}
        driver = EngineDriver(eng)
        try:
            metrics = driver.metrics()
        finally:
            driver.shutdown()
        assert (f"cdlm_moe_pairs_total {stats['pairs_total']}\n" in metrics
                and f"cdlm_moe_rows_padded_total "
                f"{stats['rows_padded_total']}\n" in metrics)
    assert runs["dense"] == runs["paged"]
    assert sorted(runs["dense"]) == [0, 1, 2]


def test_a_planted_imbalance_drops_nothing():
    """Every token's router ties (a zero router), so every token picks
    experts 0 and 1: the capacity path drops choices past each expert's
    capacity, the grouped dispatch computes all of them, in the layer (as
    every expert on every token does) and in the model's prefill and cached
    forwards (as the reference, which computes every choice, does)."""
    cfg, model = _model()
    params = _params(model, seed=6, zero_router=True)
    moe = {k: v[0] for k, v in params["slots"][0]["moe"].items()}
    x = torch.randn(2, 24, cfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    _, _, ids = MO.route(moe, x.reshape(-1, cfg.d_model), cfg)
    assert (ids == torch.arange(cfg.experts_per_token)).all()
    full = MO.apply_moe_dense_fallback(moe, x, cfg)
    grouped, _ = MO.apply_moe_grouped(moe, x, cfg)
    capacity, _ = MO.apply_moe(moe, x, cfg, moe_per_row=False)
    torch.testing.assert_close(grouped, full, rtol=TOL, atol=TOL)
    dropped = (capacity - full).abs().amax(-1) > 1e-3
    assert dropped.any()
    prompt, blocks = _sequence(2)
    want = _ref_logits(params, model, prompt, blocks)
    torch.testing.assert_close(_full_logits(params, cfg, prompt, blocks),
                               want, rtol=TOL, atol=TOL)
    torch.testing.assert_close(
        _cached_logits(params, cfg, prompt, blocks, paged=False), want,
        rtol=TOL, atol=TOL)
    cap_cfg = dataclasses.replace(cfg, moe_dispatch="capacity")
    assert (_full_logits(params, cap_cfg, prompt, blocks)
            - want).abs().max() > 1e-3


def test_qk_norm_on_and_off():
    """The plain route with the QK-norm matches the reference (which has
    it); the same weights without it do not, so the norm is computed, not
    passed over."""
    cfg, model = _model()
    params = _params(model, seed=7)
    prompt, blocks = _sequence(3)
    want = _ref_logits(params, model, prompt, blocks)
    torch.testing.assert_close(_full_logits(params, cfg, prompt, blocks),
                               want, rtol=TOL, atol=TOL)
    off = dataclasses.replace(cfg, qk_norm=False)
    assert (_full_logits(params, off, prompt, blocks) - want).abs().max() \
        > 1e-3


@pytest.mark.parametrize("E,k,T", [(4, 2, 40), (16, 4, 300)])
def test_grouped_plain_version_equals_every_expert_on_every_token(E, k, T):
    """``kernels/moe/ref.py`` against ``apply_moe_dense_fallback`` (every
    expert on every token, weighted by the gates), in fp32; the wrapper's
    CPU route is the plain version and counts into the tally."""
    cfg = dataclasses.replace(get_config("sdar-30b-a3b").reduced(),
                              n_experts=E, experts_per_token=k)
    gen = torch.Generator().manual_seed(E)
    d, f = cfg.d_model, cfg.moe_d_ff
    moe = {"router": torch.randn(d, E, generator=gen) / d ** 0.5,
           "wi_gate": torch.randn(E, d, f, generator=gen) / d ** 0.5,
           "wi_up": torch.randn(E, d, f, generator=gen) / d ** 0.5,
           "wo": torch.randn(E, f, d, generator=gen) / f ** 0.5}
    x = torch.randn(1, T, d, generator=gen)
    want = MO.apply_moe_dense_fallback(moe, x, cfg)[0]
    _, gates, ids = MO.route(moe, x[0], cfg)
    args = (x[0], gates, ids, moe["wi_gate"], moe["wi_up"], moe["wo"])
    torch.testing.assert_close(mref.grouped_experts(*args), want,
                               rtol=TOL, atol=TOL)
    tally = torch.zeros(E + 1, dtype=torch.int64)
    torch.testing.assert_close(grouped_experts(*args, tally=tally), want,
                               rtol=TOL, atol=TOL)
    counts = torch.bincount(ids.reshape(-1), minlength=E)
    assert torch.equal(tally[:E], counts)
    assert tally[E] == ((counts + mref.BM - 1) // mref.BM * mref.BM).sum()


def test_the_plain_layout_groups_every_pair_once():
    """``ref.align``: each expert's pairs in pair order in its group, each
    group padded to BM rows, each tile its expert's with its real rows."""
    E = 5
    ids = torch.tensor([[3, 0], [3, 1], [0, 3]] * 50 + [[4, 2]])
    row_of, tile_expert, tile_rows, counts = mref.align(ids, E)
    flat = ids.reshape(-1)
    assert len(torch.unique(row_of)) == len(flat)
    assert torch.equal(tile_expert[row_of // mref.BM], flat)
    padded = (counts + mref.BM - 1) // mref.BM * mref.BM
    assert len(tile_expert) * mref.BM == int(padded.sum())
    for e in range(E):
        rows = row_of[flat == e]
        assert torch.equal(rows, torch.sort(rows).values)
        assert int(tile_rows[tile_expert == e].sum()) == int(counts[e])


def test_the_bench_configuration_is_the_registry_config():
    """The benchmark's configuration file holds the registry's config as
    it runs, and every number of the published config.json."""
    path = ROOT / "bench" / "configs" / "sdar-30b-a3b.json"
    conf = SP._json(path)
    assert CL.model_config(conf["model"]) == get_config("sdar-30b-a3b")
    assert conf["reduced"] == [] and conf["reference"] == "moe_decoder"
    cfg = get_config("sdar-30b-a3b")
    for key, want in (("num_hidden_layers", cfg.n_layers),
                      ("hidden_size", cfg.d_model),
                      ("num_attention_heads", cfg.n_heads),
                      ("num_key_value_heads", cfg.n_kv_heads),
                      ("head_dim", cfg.head_dim),
                      ("intermediate_size", cfg.d_ff),
                      ("moe_intermediate_size", cfg.moe_d_ff),
                      ("num_experts", cfg.n_experts),
                      ("num_experts_per_tok", cfg.experts_per_token),
                      ("vocab_size", cfg.vocab_size),
                      ("rope_theta", cfg.rope_theta),
                      ("rms_norm_eps", cfg.norm_eps)):
        assert conf[key] == want, key


def test_serve_cli_runs_sdar_on_the_continuous_engine(capsys):
    serve.main(["--config", "sdar-30b-a3b", "--reduced", "--device", "cpu",
                "--prompt-len", "8", "--gen-length", "16", "--block-size",
                "8", "--requests", "3", "--batch", "2", "--scheduler",
                "continuous", "--cache-layout", "paged", "--fused-select"])
    out = capsys.readouterr().out
    assert "cdlm/continuous: TPS=" in out and "(3 requests on cpu)" in out
    assert "page pool:" in out
