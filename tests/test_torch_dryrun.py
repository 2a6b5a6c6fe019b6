"""The dry-run on the meta device (``repro_torch/launch/{specs,dryrun}.py``,
``repro_torch/roofline/{analysis,collectives,report}.py``) against the JAX
package's: the skipped (arch, shape) pairs and their reasons, MODEL_FLOPS,
the collective record (the reference's HLO parser on lines rendered from
the port's op list), the report's tables; the port's records of a dense
train step, an MoE decode step and a sequence-parallel decode step against
the reference's ``run_one`` and ``extrapolate_record`` compiled at a 2x4
mesh (FLOPs and collective bytes per chip within stated ratios, the
collectives both issue alike equal per period); and the counts themselves
at reduced sizes: a decode step's FLOPs equal the AI model's ``step_cost``,
a prefill's lie within 1 % of 2·N·D (N the params less the embedding
and head) plus the attention scores and the last row's lm head, the
full-depth count equals the depth-1/2 extrapolation, and the CLI writes
records the report renders."""
import ast
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.launch import specs as jax_specs  # noqa: E402
from repro.roofline import analysis as jax_analysis  # noqa: E402
from repro.roofline import hlo as jax_hlo  # noqa: E402
from repro.roofline import report as jax_report  # noqa: E402
from repro_torch.configs import ARCHITECTURES, INPUT_SHAPES, get_config  # noqa: E402,E501
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun, mesh as M, specs  # noqa: E402
from repro_torch.roofline import analysis, report  # noqa: E402
from repro_torch.roofline import ai_model  # noqa: E402
from repro_torch.roofline.collectives import collective_bytes  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TINY = M.make_tiny_mesh(data=2, model=4)
# the four shapes cut to CPU size (names kept: the plans key on them)
SMALL = {"train_4k": ShapeConfig("train_4k", 64, 4, "train"),
         "prefill_32k": ShapeConfig("prefill_32k", 64, 4, "prefill"),
         "decode_32k": ShapeConfig("decode_32k", 128, 4, "decode"),
         "long_500k": ShapeConfig("long_500k", 256, 1, "decode")}
PREFILL_MARGIN = 0.01


@contextlib.contextmanager
def _sized(arch, shape_name, cfg=None):
    """The registry's ``arch`` reduced (or ``cfg``) and ``shape_name`` cut
    to ``SMALL``'s size while the block runs."""
    cfg = cfg or get_config(arch).reduced()
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(ARCHITECTURES, arch, cfg)
        mp.setitem(INPUT_SHAPES, shape_name, SMALL[shape_name])
        yield cfg


def _jax_skip(arch, shape_name):
    """The reference's decision: its ``_decode_plan`` raises ``SkipPair``
    before it reads the mesh; train and prefill plans never skip."""
    shape = jax_specs.INPUT_SHAPES[shape_name]
    if shape.kind != "decode":
        return None
    try:
        jax_specs._decode_plan(jax_get_config(arch), None, shape)
    except jax_specs.SkipPair as e:
        return str(e)
    except AttributeError:      # past the skip checks: the mesh is None
        return None
    raise AssertionError("the reference's plan built without a mesh")


@pytest.mark.parametrize("shape_name", sorted(INPUT_SHAPES))
def test_skipped_pairs_equal_jax(shape_name):
    for arch in ARCHITECTURES:
        want = _jax_skip(arch, shape_name)
        if INPUT_SHAPES[shape_name].kind != "decode":
            assert want is None
            continue        # building a full-size train plan is not needed
        try:
            specs.build_plan(arch, shape_name, M.make_production_mesh())
            got = None
        except specs.SkipPair as e:
            got = str(e)
        assert got == want, arch
    skipped = [a for a in ARCHITECTURES if _jax_skip(a, shape_name)]
    assert skipped == (["whisper-base"] if shape_name == "long_500k" else [])


def test_shapes_equal_jax():
    assert {k: dataclasses.asdict(v) for k, v in INPUT_SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jax_specs.INPUT_SHAPES.items()}


@pytest.mark.parametrize("name", sorted(ARCHITECTURES))
def test_model_flops_equal_jax(name):
    for kind in ("train_cdlm", "train_ar", "prefill", "decode"):
        for tokens in (1, 4096, 1_048_576):
            assert analysis.model_flops(get_config(name), tokens, kind) == \
                jax_analysis.model_flops(jax_get_config(name), tokens, kind)


def _hlo(ops):
    return "\n".join(f"  %c{i} = {shape}{{1,0}} {kind}(%p{i}), "
                     "replica_groups={}" for i, (kind, _, shape, _)
                     in enumerate(ops))


@pytest.mark.parametrize("arch,shape,kw", [
    ("qwen2-0.5b", "train_4k", {}),
    ("kimi-k2-1t-a32b", "decode_32k", {"seq_parallel_decode": True}),
    ("qwen1.5-110b", "long_500k", {}),
    ("jamba-v0.1-52b", "prefill_32k", {"fsdp": False})])
def test_collective_record_equals_the_hlo_parser(arch, shape, kw):
    """The port lists a step's collectives from its specs; rendered as HLO
    lines, the reference's parser gives the same record."""
    plan = specs.build_plan(arch, shape, M.make_production_mesh(), **kw)
    assert plan.collectives
    got = collective_bytes(plan.collectives)
    assert got == jax_hlo.collective_bytes(_hlo(plan.collectives))
    assert got["wire_bytes"] == got["total_bytes"] + got["per_kind"].get(
        "all-reduce", 0.0)


def test_collective_kinds_follow_the_specs():
    mesh = M.make_production_mesh()
    kinds = lambda p: collective_bytes(p.collectives)["counts"]
    train = kinds(specs.build_plan("qwen2-0.5b", "train_4k", mesh))
    assert train["reduce-scatter"] > 0 and train["all-gather"] > 0
    assert "all-gather" not in kinds(specs.build_plan(
        "qwen2-0.5b", "train_4k", mesh, fsdp=False))
    assert kinds(specs.build_plan("kimi-k2-1t-a32b", "decode_32k",
                                  mesh))["all-to-all"] > 0
    par = specs.build_plan("qwen1.5-110b", "long_500k", mesh,
                           seq_parallel_decode=True)
    gather = specs.build_plan("qwen1.5-110b", "long_500k", mesh)
    assert par.meta["seq_shard"] and gather.meta["seq_shard"]
    assert (collective_bytes(par.collectives)["total_bytes"]
            < collective_bytes(gather.collectives)["total_bytes"])


def _small(arch, shape_name, **kw):
    with _sized(arch, shape_name):
        return dryrun.run_one(arch, shape_name, mesh=TINY, verbose=False,
                              **kw)


@pytest.fixture(scope="module")
def records():
    recs = [_small(a, s) for a, s in (
        ("qwen2-0.5b", "train_4k"), ("qwen2-0.5b", "decode_32k"),
        ("rwkv6-1.6b", "train_4k"), ("jamba-v0.1-52b", "prefill_32k"),
        ("whisper-base", "prefill_32k"), ("internvl2-1b", "train_4k"),
        ("llama4-maverick-400b-a17b", "long_500k"))]
    recs.append(_small("gemma2-27b", "decode_32k", seq_parallel_decode=True))
    recs.append({"arch": "whisper-base", "shape": "long_500k",
                 "status": "skipped", "reason": "r" * 100})
    recs.append({"arch": "dream-7b", "shape": "train_4k", "status": "error",
                 "error": "E" * 100})
    return recs


def test_records_keep_the_reference_keys(records):
    want = set(jax_analysis.RooflineReport.__dataclass_fields__) | {
        "status", "meta", "memory_analysis", "lower_s", "compile_s"}
    for rec in records:
        if rec["status"] == "ok":
            assert want <= set(rec)
            assert rec["bottleneck"] in ("compute", "memory", "collective")
            assert rec["hlo_flops"] > 0 and rec["hlo_bytes"] > 0
            mem = rec["memory_analysis"]
            assert min(mem.values()) > 0
            assert rec["per_device_mem"] == sum(mem.values())
            json.dumps(rec)


def test_report_tables_equal_jax(records):
    assert report.roofline_table(records) == \
        jax_report.roofline_table(records)
    assert report.dryrun_table(records) == jax_report.dryrun_table(records)
    assert report._fmt_s(0.5e-3) == jax_report._fmt_s(0.5e-3)


def _attention_flops(cfg, b, Lq, Lk):
    """Scores and P·V: 4 b Lq Lk H hd per attention layer."""
    return 4.0 * b * Lq * Lk * cfg.n_heads * cfg.head_dim * cfg.n_layers


def test_decode_flops_equal_the_ai_model():
    """A dense decode step, counted on meta, does the AI model's matmul
    FLOPs exactly: projections and FFN on every query token, scores and
    P·V against every cache row and the block, the lm head on every
    token."""
    shape = SMALL["decode_32k"]
    with _sized("qwen2-0.5b", "decode_32k") as cfg:
        plan = specs.build_plan("qwen2-0.5b", "decode_32k", TINY)
    got = analysis.count(plan)["flops"]
    m = ai_model.AIModelConfig(n_layers=cfg.n_layers, d_model=cfg.d_model,
                               n_heads=cfg.n_heads,
                               n_kv_heads=cfg.n_kv_heads, d_ff=cfg.d_ff,
                               vocab=cfg.vocab_size)
    want = ai_model.step_cost(m, q_tokens=specs.BLOCK,
                              ctx_tokens=shape.seq_len + specs.BLOCK,
                              batch=shape.global_batch)["flops"]
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "llada-8b", "gemma-7b"])
def test_prefill_flops_near_2nd(arch):
    shape = SMALL["prefill_32k"]
    b, Lseq = shape.global_batch, shape.seq_len
    with _sized(arch, "prefill_32k") as cfg:
        plan = specs.build_plan(arch, "prefill_32k", TINY)
    got = analysis.count(plan)["flops"]
    embed = cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    want = (2.0 * (cfg.param_count() - embed) * b * Lseq
            + _attention_flops(cfg, b, Lseq, Lseq)
            + 2.0 * b * cfg.d_model * cfg.vocab_size)
    assert abs(got / want - 1) < PREFILL_MARGIN, (got, want)


@pytest.mark.parametrize("arch,shape_name", [
    ("qwen2-0.5b", "train_4k"), ("jamba-v0.1-52b", "decode_32k"),
    ("kimi-k2-1t-a32b", "prefill_32k")])
def test_full_depth_count_equals_the_extrapolation(arch, shape_name):
    cfg = get_config(arch).reduced(
        n_layers=4 * len(get_config(arch).layer_period))
    with _sized(arch, shape_name, cfg):
        rec = dryrun.run_one(arch, shape_name, mesh=TINY, verbose=False)
        dryrun.extrapolate_record(rec, mesh=TINY)
    ex = rec["extrapolated"]
    assert ex["n_periods"] == 4 and ex["linear"], ex
    assert ex["per_period"]["flops"] > 0
    assert math.isclose(ex["extrapolated"]["flops"],
                        rec["hlo_flops"] * rec["chips"], rel_tol=1e-9)


def test_cli_writes_records_the_report_renders(tmp_path, monkeypatch,
                                               capsys):
    monkeypatch.chdir(tmp_path)
    for shape in ("decode_32k", "long_500k"):
        arch = "qwen2-0.5b" if shape == "decode_32k" else "whisper-base"
        assert dryrun.main(["--arch", arch, "--shape", shape]) == 0
    recs = json.loads((tmp_path / dryrun.OUT_DIR / "dryrun.json").read_text())
    assert [r["status"] for r in recs] == ["ok", "skipped"]
    assert recs[0]["mesh"] == "16x16" and recs[0]["chips"] == 256
    report.main(str(tmp_path / dryrun.OUT_DIR))
    out = capsys.readouterr().out
    assert report.roofline_table(recs) in out
    assert "| whisper-base | long_500k | SKIP |" in out


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "rwkv6-1.6b"])
def test_recurrence_backward_bytes_grow_linearly(arch):
    """A Mamba or RWKV mixer's forward and backward, counted on meta,
    move bytes linear in the tokens: the token loop splits its inputs once,
    so no token's backward fills a zero gradient of the whole sequence
    (which made jamba's and rwkv6's train_4k count 10^3-10^4 times the
    bytes)."""
    from repro_torch.models import mamba as MB
    from repro_torch.models import rwkv6 as RW
    from repro_torch.launch.specs import abstract_params
    cfg = get_config(arch).reduced(dtype="bfloat16")
    slot = abstract_params(cfg)["slots"][0]

    def counted(L):
        x = torch.empty((2, L, cfg.d_model), dtype=torch.bfloat16,
                        device="meta", requires_grad=True)
        counter = analysis.MetaCounter()
        with counter:
            if arch.startswith("jamba"):
                p = {k: v[0] for k, v in slot["mamba"].items()}
                y, _ = MB.mamba_forward(p, x, cfg)
            else:
                p = {k: v[0] for k, v in slot["rwkv_tm"].items()}
                y, _ = RW.time_mix(p, x, cfg, RW.init_rwkv_state(
                    cfg, 2, dtype=torch.bfloat16, device="meta"))
            torch.autograd.grad(y.float().sum(), x)
        return counter.bytes

    small, large = counted(64), counted(256)
    assert large / small < 4.4, (small, large)     # quadratic: ~16


# The reference's dry-run against the port's at a 2x4 mesh (8 forced host
# devices; tests/_torch_dryrun_ref.py): [arch, shape, kind, seq_len,
# batch, overrides of reduced(), plan kwargs]. Four KV heads divide the
# model axis, so XLA partitions the attention without resharding heads.
REF_CASES = [
    ["qwen2-0.5b", "train_4k", "train", 64, 4, {"n_kv_heads": 4}, {}],
    ["kimi-k2-1t-a32b", "decode_32k", "decode", 128, 4, {"n_kv_heads": 4},
     {}],
    ["qwen2-0.5b", "decode_32k", "decode", 128, 4, {"n_kv_heads": 4},
     {"seq_parallel_decode": True}]]
# the port's FLOPs per chip over the reference's, extrapolated: XLA also
# counts elementwise ops (train, MoE decode); in the sequence-parallel
# decode XLA gathers every weight whole and runs the projections and the
# MLP replicated over the model axis, where the port's count splits them
REF_FLOPS_RATIO = [(0.93, 1.0), (0.93, 1.0), (0.25, 0.35)]
# the port's collective bytes per chip over the reference's, the sizes of
# the divergences PERF.md names: XLA runs the dense MLP 8-way with the
# batch gathered, reduces gradients by all-reduce at the model shard's
# size, routes MoE tokens over the data axis and gathers weights in the
# sequence-parallel decode
REF_COLL_RATIO = [(0.55, 0.75), (1.0, 1.4), (0.3, 0.45)]
# per-period collectives (kind|axes|shape) both issue alike: the FSDP
# gathers of wq, wk, wv and wo once per pass (3 forwards + 2 backwards),
# and the sequence-parallel decode's merges of acc, m and l
REF_MATCHED = [["all-gather|data|f32[256,64]", "all-gather|data|f32[64,256]"],
               [],
               ["all-reduce|model|f32[2,4,32,64]",
                "all-reduce|model|f32[2,4,32,1]"]]


@pytest.fixture(scope="module")
def reference_records(tmp_path_factory):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    p = subprocess.run([sys.executable, str(ROOT / "tests" /
                                             "_torch_dryrun_ref.py"),
                        json.dumps(REF_CASES)], capture_output=True,
                       text=True, env=env, timeout=600,
                       cwd=tmp_path_factory.mktemp("ref"))
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def _per_period(arch, shape_name, **kw):
    def ops(k):
        out = {}
        plan = specs.build_plan(arch, shape_name, TINY, roofline_periods=k,
                                **kw)
        for kind, _, shape, axes in plan.collectives:
            key = f"{kind}|{','.join(axes)}|{shape}"
            out[key] = out.get(key, 0) + 1
        return out
    o1, o2 = ops(1), ops(2)
    return {k: o2.get(k, 0) - o1.get(k, 0) for k in set(o1) | set(o2)
            if o2.get(k, 0) != o1.get(k, 0)}


@pytest.mark.parametrize("case", range(len(REF_CASES)))
def test_dryrun_against_the_reference_at_2x4(case, reference_records):
    """The port's record of a dense train step, an MoE decode step and a
    sequence-parallel decode step against the reference's compiled one:
    FLOPs per chip and collective bytes within the stated ratios, and the
    collectives both plans issue alike equal per period, kind, mesh axes
    and shape."""
    arch, shape_name, kind, seq_len, batch, ovr, kw = REF_CASES[case]
    ref = reference_records[case]
    cfg = get_config(arch).reduced(**ovr)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(ARCHITECTURES, arch, cfg)
        mp.setitem(INPUT_SHAPES, shape_name,
                   ShapeConfig(shape_name, seq_len, batch, kind))
        rec = dryrun.run_one(arch, shape_name, mesh=TINY, verbose=False,
                             **kw)
        mine = _per_period(arch, shape_name, **kw)
    theirs = ref["per_period"]
    print(f"\n{arch} {shape_name} {kw}: FLOPs/chip {rec['hlo_flops']:.4g} "
          f"vs {ref['flops']:.4g}, collective bytes/chip "
          f"{rec['coll_bytes']:.4g} vs {ref['coll_total']:.4g}")
    for key in sorted(set(mine) | set(theirs)):
        print(f"  {key:42s} port {mine.get(key, 0):3d}  "
              f"reference {theirs.get(key, 0):3d}")
    lo, hi = REF_FLOPS_RATIO[case]
    assert lo <= rec["hlo_flops"] / ref["flops"] <= hi
    lo, hi = REF_COLL_RATIO[case]
    assert lo <= rec["coll_bytes"] / ref["coll_total"] <= hi
    for key in REF_MATCHED[case]:
        assert mine.get(key, 0) == theirs.get(key, 0) > 0, key


def _jax_variants():
    """The reference's ``launch/perf.py::VARIANTS``, read from its source:
    importing it would set ``XLA_FLAGS`` in this process."""
    src = (ROOT / "src" / "repro" / "launch" / "perf.py").read_text()
    for node in ast.parse(src).body:
        if (isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", None) == "VARIANTS"):
            return ast.literal_eval(node.value)
    raise AssertionError("no VARIANTS")


def test_perf_variants_equal_jax_and_aliases_count_once(tmp_path,
                                                        monkeypatch):
    """The ten variants are the reference's; the three whose step is an
    earlier tag's take its record and are not counted again."""
    from repro_torch.launch import perf
    assert [tuple(v) for v in perf.VARIANTS] == [tuple(v) for v in
                                                  _jax_variants()]
    steps = {tag: (arch, shape, kw) for tag, arch, shape, kw in perf.VARIANTS}
    for tag, twin in perf.ALIASES.items():
        assert steps[tag] == steps[twin]
    counted = []

    def run_one(arch, shape, verbose, **kw):
        counted.append((arch, shape, kw))
        return {"compute_s": len(counted), "memory_s": 0.0,
                "collective_s": 0.0, "bottleneck": "compute",
                "useful_ratio": 1.0, "coll_detail": {"top_ops": []}}

    monkeypatch.setattr(perf, "run_one", run_one)
    monkeypatch.setattr(perf, "extrapolate_record", lambda rec, **kw: rec)
    monkeypatch.chdir(tmp_path)
    assert perf.main([]) == 0
    assert len(counted) == len(perf.VARIANTS) - len(perf.ALIASES)
    recs = json.loads((tmp_path / perf.OUT_DIR / "perf.json").read_text())
    assert sorted(recs) == sorted(steps)
    for tag, twin in perf.ALIASES.items():
        assert recs[tag]["alias_of"] == twin
        assert recs[tag]["compute_s"] == recs[twin]["compute_s"]
