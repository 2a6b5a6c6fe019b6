"""The port's kernel tuning registry (``repro_torch/kernels/tuning.py``)
against the JAX package's (``repro/kernels/tuning.py``): the config's
round trip, the select and xent buckets, the resolution precedence on a
temporary table, the built-in rules an empty table gives at the main
path's shapes, every candidate split of the decode kernel's plain model
against the JAX oracle, and the sweep's refusal off the card."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import tuning as jax_tuning  # noqa: E402
from repro.kernels.decode_attn import decode_attention_ref  # noqa: E402
from repro_torch.kernels import _build, tuning  # noqa: E402
from repro_torch.kernels.decode_attn import ref as dref  # noqa: E402
from repro_torch.kernels.select import ops as sops  # noqa: E402
from repro_torch.kernels.xent import ops as xops  # noqa: E402

torch.set_num_threads(2)

CARD = "cuda:NVIDIA H100 80GB HBM3"
H100_SMS = 132
# (config, Kv, G, V) of the main path's three models
MODELS = [("qwen2-0.5b", 2, 7, 151_936), ("dream-7b", 4, 7, 152_064),
          ("llada-8b", 32, 1, 126_464)]


def _table(monkeypatch, path, entries):
    """Point the registry at a table of ``entries`` for one test."""
    path.write_text(json.dumps({"version": 1, "entries": entries}))
    monkeypatch.setattr(tuning, "TABLE_PATH", path)
    tuning.clear_cache()
    return path


def test_kernel_config_round_trips_and_refuses_unknown_fields():
    cfg = tuning.KernelConfig(tiles_per_split=4, bwd_chunk=2048)
    assert cfg.to_dict() == {"tiles_per_split": 4, "bwd_chunk": 2048}
    assert tuning.KernelConfig.from_dict(cfg.to_dict()) == cfg
    assert tuning.KernelConfig().to_dict() == {}
    with pytest.raises(ValueError, match="unknown KernelConfig fields"):
        tuning.KernelConfig.from_dict({"tiles_per_split": 2, "block_k": 64})
    # hashable: the sweep's candidates are deduplicated by it
    assert len({cfg, tuning.KernelConfig.from_dict(cfg.to_dict())}) == 1


@pytest.mark.parametrize("op", ["select", "xent"])
@pytest.mark.parametrize("V", [128, 1000, 32_768, 32_769, 126_464, 131_072,
                               151_936, 152_064])
def test_vocab_buckets_equal_jax(op, V):
    """JAX's vocabulary bucket, then the rows' (the built-in rules read T,
    so an entry holds at its own T's bucket only)."""
    for T, tb in ((1, 1), (256, 256), (1000, 1024), (1024, 1024),
                  (4096, 4096), (8192, 8192)):
        assert tuning.bucket_for(op, V=V, T=T) == \
            f"{jax_tuning.bucket_for(op, V=V)}_T{tb}"


def test_block_attention_bucket_equals_jax_and_has_no_knob():
    for L in (100, 512, 576, 2048):
        assert tuning.bucket_for("block_attn", L=L) == \
            jax_tuning.bucket_for("block_attn", L=L)
    assert tuning.resolve("block_attn", backend_name=CARD, L=512) == \
        tuning.KernelConfig()
    assert tuning.candidates("block_attn", L=512) == []


def test_decode_bucket_reads_kv_heads_and_rows_only():
    """Not the cache length: the dense and paged kernels must split
    alike."""
    assert tuning.bucket_for("decode_attn", Kv=2, rows=224) == "Kv2_R256"
    assert tuning.bucket_for("decode_attn", Kv=32, rows=1) == "Kv32_R1"
    assert tuning.bucket_for("decode_attn", Kv=4, rows=7) == "Kv4_R8"
    with pytest.raises(ValueError, match="unknown op"):
        tuning.bucket_for("attn", L=1)


def test_resolve_precedence_on_a_temporary_table(tmp_path, monkeypatch):
    """config= field > the table's entry for (op, bucket, backend) > the
    built-in rule; another card's or another bucket's entry is never
    applied."""
    shape = dict(T=256, V=151_936, n_sms=H100_SMS, dtype=torch.bfloat16)
    rule = tuning.OP_DEFAULTS["select"](**shape)
    _table(monkeypatch, tmp_path / "t.json", [
        {"op": "select", "bucket": "V262144_T256", "backend": CARD,
         "config": {"vocab_tiles_per_chunk": 7}},
        {"op": "decode_attn", "bucket": "Kv2_R256", "backend": CARD,
         "config": {"tiles_per_split": 4}},
        {"op": "xent", "bucket": "V262144_T1024", "backend": CARD,
         "config": {"bwd_chunk": 1024}}])
    res = tuning.resolve
    assert res("select", backend_name=CARD, **shape) == \
        tuning.KernelConfig(vocab_tiles_per_chunk=7)
    assert res("select", backend_name=CARD, config=tuning.KernelConfig(
        vocab_tiles_per_chunk=3), **shape).vocab_tiles_per_chunk == 3
    assert res("select", backend_name="cuda:another card", **shape) == rule
    assert res("select", backend_name=CARD, T=256, V=32_768, n_sms=H100_SMS,
               dtype=torch.bfloat16) == tuning.OP_DEFAULTS["select"](
        T=256, V=32_768, n_sms=H100_SMS, dtype=torch.bfloat16)
    assert res("decode_attn", backend_name=CARD, Kv=2,
               rows=224).tiles_per_split == 4
    assert res("decode_attn", backend_name=CARD, Kv=2,
               rows=7).tiles_per_split == dref.tiles_per_split(2, 7)
    # a table entry sets only its own knob: the forward keeps its rule
    xs = dict(T=1024, V=151_936, n_sms=H100_SMS, dtype=torch.bfloat16)
    got = res("xent", backend_name=CARD, **xs)
    assert got.bwd_chunk == 1024
    assert got.vocab_tiles_per_chunk == \
        tuning.OP_DEFAULTS["xent"](**xs).vocab_tiles_per_chunk
    # ... at its own rows only: at 4x the rows the rule's chunk holds
    x4 = dict(xs, T=4096)
    assert res("xent", backend_name=CARD, **x4) == \
        tuning.OP_DEFAULTS["xent"](**x4)
    tuning.clear_cache()


def test_table_values_out_of_range_raise(tmp_path, monkeypatch):
    """No fallback: a knob its kernel cannot take raises."""
    _table(monkeypatch, tmp_path / "bad.json", [
        {"op": "decode_attn", "bucket": "Kv2_R256", "backend": CARD,
         "config": {"tiles_per_split": 16}}])
    with pytest.raises(ValueError, match="tiles_per_split"):
        tuning.resolve("decode_attn", backend_name=CARD, Kv=2, rows=224)
    with pytest.raises(ValueError, match="bwd_chunk"):
        tuning.resolve("xent", backend_name=CARD,
                       config=tuning.KernelConfig(bwd_chunk=100), T=64,
                       V=1000, n_sms=H100_SMS, dtype=torch.bfloat16)
    tuning.clear_cache()


def test_save_table_replaces_same_key_rows(tmp_path, monkeypatch):
    path = tmp_path / "t.json"
    monkeypatch.setattr(tuning, "TABLE_PATH", path)
    tuning.clear_cache()
    e = {"op": "select", "bucket": "V32768_T256", "backend": CARD,
         "config": {"vocab_tiles_per_chunk": 5}}
    tuning.save_table([e])
    tuning.save_table([dict(e, config={"vocab_tiles_per_chunk": 6}),
                       dict(e, backend="cuda:other")])
    rows = json.loads(path.read_text())["entries"]
    assert len(rows) == 2
    assert tuning.lookup("select", "V32768_T256",
                         backend_name=CARD).vocab_tiles_per_chunk == 6
    # a swept bucket that no candidate won loses its old row
    tuning.save_table([], drop={("select", "V32768_T256", CARD)})
    assert tuning.lookup("select", "V32768_T256", backend_name=CARD) is None
    assert tuning.lookup("select", "V32768_T256",
                         backend_name="cuda:other") is not None
    tuning.clear_cache()


@pytest.mark.parametrize("name,Kv,G,V", MODELS, ids=[m[0] for m in MODELS])
def test_empty_table_reproduces_the_built_in_rules(tmp_path, monkeypatch,
                                                  name, Kv, G, V):
    """With no entry, every wrapper launches what the rules of the kernels
    gave before the table: the decode split (``ref.split_plan``), the
    select and xent forward chunking (``_build.chunking``) and the xent
    backward chunk (``backward_chunk``), bf16 and fp32 tiles."""
    _table(monkeypatch, tmp_path / "empty.json", [])
    for Bq in (32, 1):
        for S in (576, 768, 1000):
            T, n = dref.split_plan(Kv, Bq, G, S)
            got = tuning.resolve("decode_attn", backend_name=CARD, Kv=Kv,
                                 rows=Bq * G)
            assert dref.split_plan(Kv, Bq, G, S, got.tiles_per_split) == \
                (T, n)
    for dtype in (torch.bfloat16, torch.float32):
        for T in (128, 256, 1024):
            shape = dict(T=T, V=V, n_sms=H100_SMS, dtype=dtype)
            sel = tuning.resolve("select", backend_name=CARD, **shape)
            per, n = _build.chunking(T, V, H100_SMS, *sops.TILES[dtype])
            assert sel.vocab_tiles_per_chunk == per
            assert _build.n_chunks(V, sops.TILES[dtype][1], per) == n
            xe = tuning.resolve("xent", backend_name=CARD, **shape)
            per, n = _build.chunking(T, V, H100_SMS, *xops.TILES[dtype])
            assert xe.vocab_tiles_per_chunk == per
            assert _build.n_chunks(V, xops.TILES[dtype][1], per) == n
            assert xe.bwd_chunk == xops.backward_chunk(T, V)
    tuning.clear_cache()


def test_checked_in_table_is_valid_and_holds_no_cpu_entry():
    """Every entry of the cuda table parses, names a card, and resolves at
    its own shape; none is keyed to the CPU, so the CPU tests run on the
    built-in rules."""
    tuning.clear_cache()
    data = json.loads(tuning.TABLE_PATH.read_text())
    for e in data["entries"]:
        assert e["backend"].startswith("cuda:"), e
        cfg = tuning.KernelConfig.from_dict(e["config"])
        sh = e["shape"]
        if e["op"] == "decode_attn":
            shape = dict(Kv=sh["Kv"], rows=sh["Bq"] * sh["G"])
        else:
            shape = dict(T=sh["T"], V=sh["V"], n_sms=sh["n_sms"],
                         dtype=torch.bfloat16)
        assert tuning.bucket_for(e["op"], **shape) == e["bucket"]
        got = tuning.resolve(e["op"], backend_name=e["backend"], **shape)
        assert {k: getattr(got, k) for k in cfg.to_dict()} == cfg.to_dict()
    assert tuning.backend("cpu") == "cpu"
    assert not [e for e in data["entries"] if e["backend"] == "cpu"]


def test_candidates_hold_the_rule_first_and_stay_in_range():
    for name, Kv, G, V in MODELS:
        for Bq in (32, 1):
            c = tuning.candidates("decode_attn", Kv=Kv, rows=Bq * G)
            assert c[0] == tuning.OP_DEFAULTS["decode_attn"](Kv=Kv,
                                                             rows=Bq * G)
            assert sorted(x.tiles_per_split for x in c) == [1, 2, 4, 8]
    sh = dict(T=1024, V=151_936, n_sms=H100_SMS, dtype=torch.bfloat16)
    c = tuning.candidates("xent", **sh)
    assert c[0] == tuning.OP_DEFAULTS["xent"](**sh) and len(set(c)) == len(c)
    assert all(x.bwd_chunk % 128 == 0 and x.bwd_chunk <= 151_936 + 127
               for x in c)


def _sweep_log(groups):
    """Sweep log rows (``tuning._row``'s form) from ``{(op, bucket, part):
    (rule knobs, [(knobs, us), ...])}``."""
    return [{"op": op, "bucket": bucket, "part": part, "shape": {},
             "knobs": knobs, "builtin": rule, "us": us}
            for (op, bucket, part), (rule, times) in groups.items()
            for knobs, us in [(rule, times[0])] + list(times[1:])]


def test_pick_entries_holds_a_winner_to_every_sweep():
    """A candidate goes into the table only if it beat its sweep's rule by
    more than the margin in each sweep; with one sweep, SWEEP_MARGIN."""
    r, c1, c4 = ({"tiles_per_split": t} for t in (2, 1, 4))
    a = _sweep_log({("decode_attn", "Kv2_R8", "call"):
                    (r, [12.0, (c1, 11.0), (c4, 12.5)])})
    b = _sweep_log({("decode_attn", "Kv2_R8", "call"):
                    (r, [12.2, (c1, 11.1), (c4, 11.5)])})
    got, margin = tuning.pick_entries([a], CARD)
    assert margin == tuning.SWEEP_MARGIN
    assert [e["config"] for e in got] == [c1]
    assert got[0]["us"] == {"call": {"builtin": [12.0], "tuned": [11.0]}}
    # split 4 wins sweep b alone (by 5.7 %) and loses sweep a: split 1 holds
    got, margin = tuning.pick_entries([a, b], CARD)
    assert margin == pytest.approx(max(tuning.SWEEP_MARGIN, 12.2 / 12 - 1))
    assert [(e["bucket"], e["backend"], e["config"]) for e in got] == \
        [("Kv2_R8", CARD, c1)]
    assert got[0]["us"]["call"] == {"builtin": [12.0, 12.2],
                                    "tuned": [11.0, 11.1]}
    assert tuning.pick_entries([a, _sweep_log({
        ("decode_attn", "Kv2_R8", "call"): (r, [12.0, (c1, 12.3)])})],
        CARD)[0] == []


def test_pick_entries_margin_is_the_rules_spread_between_sweeps():
    """When a rule's own time moves between the sweeps by more than
    SWEEP_MARGIN, a gain must exceed that spread."""
    r, c = {"tiles_per_split": 8}, {"tiles_per_split": 4}
    a = _sweep_log({("decode_attn", "Kv32_R32", "call"): (r, [54.75,
                                                              (c, 53.14)]),
                    ("decode_attn", "Kv32_R1", "call"): (r, [47.08,
                                                             (c, 40.94)])})
    b = _sweep_log({("decode_attn", "Kv32_R32", "call"): (r, [52.0,
                                                              (c, 49.0)]),
                    ("decode_attn", "Kv32_R1", "call"): (r, [47.5,
                                                             (c, 41.2)])})
    got, margin = tuning.pick_entries([a, b], CARD)
    assert margin == pytest.approx(54.75 / 52.0 - 1)
    # Kv32_R32 gains 2.9 % and 5.8 %, under the 5.3 % spread in sweep a
    assert [e["bucket"] for e in got] == ["Kv32_R1"]
    assert got[0]["margin"] == round(margin, 4)


def test_pick_entries_joins_the_xent_parts_and_sets_only_their_knobs():
    rule = {"vocab_tiles_per_chunk": 75, "bwd_chunk": 4096}
    fwd = dict(rule, vocab_tiles_per_chunk=38)
    bwd = dict(rule, bwd_chunk=8192)
    log = _sweep_log({
        ("xent", "V262144_T1024", "forward"): (rule, [726.0, (fwd, 650.0)]),
        ("xent", "V262144_T1024", "backward"): (rule, [2797.0,
                                                       (bwd, 2626.0)]),
        ("xent", "V262144_T4096", "backward"): (rule, [9000.0,
                                                       (bwd, 8950.0)])})
    got, _ = tuning.pick_entries([log, log], CARD)
    assert len(got) == 1
    e = got[0]
    assert (e["op"], e["bucket"]) == ("xent", "V262144_T1024")
    assert e["config"] == {"vocab_tiles_per_chunk": 38, "bwd_chunk": 8192}
    assert set(e["us"]) == {"forward", "backward"}
    assert e["builtin"] == rule


def _split_inputs(b, Bq, Kv, G, hd, S, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(0, 1, s).astype(np.float32)  # noqa: E731
    return (f(b, Bq, Kv, G, hd), f(b, S, Kv, hd), f(b, S, Kv, hd),
            f(b, Bq, Kv, hd), f(b, Bq, Kv, hd))


@pytest.mark.parametrize("tiles", [1, 2, 4, 8])
@pytest.mark.parametrize("Kv,G,hd,Bq", [(2, 7, 64, 32), (4, 7, 128, 1)],
                         ids=["qwen2-0.5b block", "dream-7b AR step"])
def test_every_candidate_split_matches_the_jax_oracle(tiles, Kv, G, hd, Bq):
    """The plain model of the bf16 kernel's split, at each split the sweep
    tries, in fp32 against the JAX oracle: the same sums in another
    grouping, 1e-5; dense and paged alike."""
    b, S = 3, 600
    lens = [0, 64 * tiles + 1, S]
    q, kc, vc, kb, vb = _split_inputs(b, Bq, Kv, G, hd, S, seed=tiles + hd)
    t = [torch.as_tensor(a) for a in (q, kc, vc, kb, vb)]
    cl = torch.tensor(lens, dtype=torch.int32)
    kw = dict(scale=hd ** -0.5)
    got = dref.decode_attention_split(*t, cl, tiles=tiles, **kw)
    page = 40
    pool_k = t[1].reshape(b * S // page, page, Kv, hd)
    pool_v = t[2].reshape(b * S // page, page, Kv, hd)
    table = torch.arange(b * S // page, dtype=torch.int32).reshape(b, -1)
    paged = dref.decode_attention_split(t[0], pool_k, pool_v, t[3], t[4], cl,
                                        page_table=table, tiles=tiles, **kw)
    assert torch.equal(paged, got)
    for i, n in enumerate(lens):
        lane = [jnp.asarray(a[i:i + 1]) for a in (q, kc, vc, kb, vb)]
        want = decode_attention_ref(*lane, n, **kw)
        np.testing.assert_allclose(got[i:i + 1].numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def test_run_sweep_raises_off_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(tuning, "TABLE_PATH", tmp_path / "t.json")
    with pytest.raises(RuntimeError, match="plain versions"):
        tuning.run_sweep(device="cpu")
    assert not (tmp_path / "t.json").exists()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tuning.run_sweep()
    assert not (tmp_path / "t.json").exists()


def test_wrappers_on_the_cpu_take_config_and_ignore_it():
    """A CPU tensor takes the plain version whatever the knobs."""
    from repro_torch.kernels.decode_attn import decode_attention
    from repro_torch.kernels.select import fused_select
    from repro_torch.kernels.xent import fused_xent
    g = torch.Generator().manual_seed(0)
    q = torch.randn((2, 4, 2, 2, 64), generator=g)
    kc, vc = torch.randn((2, 16, 2, 64), generator=g), torch.randn(
        (2, 16, 2, 64), generator=g)
    kb, vb = torch.randn((2, 4, 2, 64), generator=g), torch.randn(
        (2, 4, 2, 64), generator=g)
    cl = torch.tensor([3, 16], dtype=torch.int32)
    base = decode_attention(q, kc, vc, kb, vb, cl)
    assert torch.equal(decode_attention(
        q, kc, vc, kb, vb, cl, config=tuning.KernelConfig(tiles_per_split=1)),
        base)
    h, w = torch.randn((5, 32), generator=g), torch.randn((50, 32),
                                                           generator=g)
    m = torch.ones(5, dtype=torch.bool)
    c0, f0 = fused_select(h, w, m)
    c1, f1 = fused_select(h, w, m, config=tuning.KernelConfig(
        vocab_tiles_per_chunk=1))
    assert torch.equal(c0, c1) and torch.equal(f0, f1)
    y = torch.randint(0, 50, (5,), generator=g)
    assert torch.equal(fused_xent(h, w, y), fused_xent(
        h, w, y, config=tuning.KernelConfig(bwd_chunk=128)))
