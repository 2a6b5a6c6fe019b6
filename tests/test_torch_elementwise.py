"""The forward's fused elementwise passes (``repro_torch/kernels/elementwise``)
on the CPU: each plain version (``ref.py``) against today's chain of
``models/layers.py`` ops, bit for bit; the wrappers' CPU route; which pass
``forward`` takes for which input (a recording bundle, with CPU tensors
passing for CUDA ones where the test says so); and the kernels' names
in the benchmark's device groups. The CUDA kernels themselves are held
against the plain versions by ``test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import dataclasses
import re
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.bridge import init_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ATTN, ATTN_LOCAL, MLP  # noqa: E402
from repro_torch.core import cache as C  # noqa: E402
from repro_torch.core.block_loop import (  # noqa: E402
    KERNELS,
    PLAIN,
    SamplerSpec,
    lane_block_forward,
)
from repro_torch.kernels.elementwise import (  # noqa: E402
    ElementwiseFns,
    add_rmsnorm,
    gated_act,
    qkv_rope,
)
from repro_torch.kernels.elementwise import ref  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT / "bench") not in sys.path:
    sys.path.insert(0, str(ROOT / "bench"))
from harness import trace as TR  # noqa: E402

torch.set_num_threads(2)
CU = ROOT / "src/repro_torch/kernels/elementwise/csrc/elementwise.cu"
BF16 = torch.bfloat16


def _randn(gen, *shape, scale=1.0, dtype=BF16):
    return (torch.randn(shape, generator=gen) * scale).to(dtype)


# ---------------------------------------------------------------------------
# the plain versions against today's chains of layers.py ops
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["dream-7b", "llada-8b", "qwen2-0.5b",
                                  "gemma-7b", "gemma2-27b", "kimi-k2-1t-a32b"])
@pytest.mark.parametrize("with_delta", [True, False], ids=["add", "no-add"])
def test_add_rmsnorm_plain_equals_the_layers_chain(arch, with_delta):
    cfg = get_config(arch)
    d = cfg.d_model
    gen = torch.Generator().manual_seed(d)
    x = _randn(gen, 2, 5, d, scale=3.0)
    delta = _randn(gen, 2, 5, d) if with_delta else None
    w = _randn(gen, d, scale=0.1) + 1
    want_x = x + delta if with_delta else x
    want_h = L.apply_norm({"w": w}, want_x, cfg)
    got_x, got_h = ref.add_rmsnorm(x, delta, w, cfg.norm_eps)
    assert torch.equal(got_x, want_x) and torch.equal(got_h, want_h)


def _qkv_cfg(hd: int, bias: bool):
    base = get_config("dream-7b" if bias else "llada-8b")
    return dataclasses.replace(base, d_model=256, n_heads=8, n_kv_heads=2,
                               head_dim=hd)


@pytest.mark.parametrize("hd", [64, 112, 128, 256])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no-bias"])
@pytest.mark.parametrize("per_lane", [True, False],
                         ids=["lane-positions", "shared-positions"])
def test_qkv_rope_plain_equals_the_layers_chain(hd, bias, per_lane):
    """Projections, biases (dream-7b, qwen2) or none (llada-8b), then RoPE
    at positions up to ~800 (the angles the fused pass takes sincos of)."""
    cfg = _qkv_cfg(hd, bias)
    gen = torch.Generator().manual_seed(hd + bias)
    b, n, d = 3, 6, cfg.d_model
    nq, nkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    p = {"wq": _randn(gen, d, nq, scale=0.05),
         "wk": _randn(gen, d, nkv, scale=0.05),
         "wv": _randn(gen, d, nkv, scale=0.05)}
    if bias:
        p.update(bq=_randn(gen, nq, scale=0.1), bk=_randn(gen, nkv, scale=0.1),
                 bv=_randn(gen, nkv, scale=0.1))
    h = _randn(gen, b, n, d)
    pos = (torch.tensor([[0], [511], [790]]) + torch.arange(n) if per_lane
           else 700 + torch.arange(n))
    want_q = L.rope(L.project_q(p, h, cfg), pos, cfg.rope_theta)
    want_k, want_v = L.project_kv(p, h, cfg)
    want_k = L.rope(want_k, pos, cfg.rope_theta)
    q, k, v = ref.qkv_rope(h @ p["wq"], h @ p["wk"], h @ p["wv"],
                           p.get("bq"), p.get("bk"), p.get("bv"), pos,
                           head_dim=hd, theta=cfg.rope_theta)
    assert torch.equal(q.reshape(want_q.shape), want_q)
    assert torch.equal(k.reshape(want_k.shape), want_k)
    assert torch.equal(v.reshape(want_v.shape), want_v)


@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no-bias"])
def test_qkv_rope_qk_norm_plain_equals_the_layers_chain(hd, bias):
    """A QK-norm config (sdar-30b-a3b's Qwen3 layers): the projections,
    their biases where given, each head of q and k RMS-normed by its (hd,)
    weight (``layers.head_norm``), then RoPE: the plain version equals that
    chain bit for bit; the wrapper's CPU route takes it."""
    cfg = dataclasses.replace(_qkv_cfg(hd, bias), qk_norm=True)
    gen = torch.Generator().manual_seed(hd + 7 * bias)
    b, n, d = 3, 6, cfg.d_model
    nq, nkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    p = {"wq": _randn(gen, d, nq, scale=0.05),
         "wk": _randn(gen, d, nkv, scale=0.05),
         "wv": _randn(gen, d, nkv, scale=0.05),
         "q_norm": _randn(gen, hd, scale=0.1) + 1,
         "k_norm": _randn(gen, hd, scale=0.1) + 1}
    if bias:
        p.update(bq=_randn(gen, nq, scale=0.1), bk=_randn(gen, nkv, scale=0.1),
                 bv=_randn(gen, nkv, scale=0.1))
    h = _randn(gen, b, n, d)
    pos = torch.tensor([[0], [511], [790]]) + torch.arange(n)
    want_q = L.rope(L.head_norm(L.project_q(p, h, cfg), p["q_norm"],
                                cfg.norm_eps), pos, cfg.rope_theta)
    want_k, want_v = L.project_kv(p, h, cfg)
    want_k = L.rope(L.head_norm(want_k, p["k_norm"], cfg.norm_eps), pos,
                    cfg.rope_theta)
    args = (h @ p["wq"], h @ p["wk"], h @ p["wv"], p.get("bq"), p.get("bk"),
            p.get("bv"), pos)
    kw = dict(head_dim=hd, theta=cfg.rope_theta, q_norm=p["q_norm"],
              k_norm=p["k_norm"], eps=cfg.norm_eps)
    for q, k, v in (ref.qkv_rope(*args, **kw), qkv_rope(*args, **kw)):
        assert torch.equal(q.reshape(want_q.shape), want_q)
        assert torch.equal(k.reshape(want_k.shape), want_k)
        assert torch.equal(v.reshape(want_v.shape), want_v)


@pytest.mark.parametrize("kind", ["silu", "gelu"])
def test_gated_act_plain_equals_the_layers_chain(kind):
    gen = torch.Generator().manual_seed(len(kind))
    g, u = _randn(gen, 4, 7, 64, scale=4.0), _randn(gen, 4, 7, 64)
    assert torch.equal(ref.gated_act(g, u, kind), L.act(g, kind) * u)


def test_gated_act_plain_refuses_a_plain_activation():
    g = torch.zeros(2, 8, dtype=BF16)
    with pytest.raises(ValueError, match="no gated activation"):
        ref.gated_act(g, g, "gelu_plain")


def test_wrappers_take_the_plain_versions_on_the_cpu():
    gen = torch.Generator().manual_seed(3)
    x, delta = _randn(gen, 2, 3, 64), _randn(gen, 2, 3, 64)
    w = _randn(gen, 64)
    q, k, v = (_randn(gen, 2, 3, n * 64) for n in (4, 2, 2))
    pos = torch.arange(3)
    before = (add_rmsnorm.launches, qkv_rope.launches, gated_act.launches)
    for got, want in ((add_rmsnorm(x, delta, w, 1e-6),
                       ref.add_rmsnorm(x, delta, w, 1e-6)),
                      (qkv_rope(q, k, v, None, None, None, pos, head_dim=64,
                                theta=1e4),
                       ref.qkv_rope(q, k, v, None, None, None, pos,
                                    head_dim=64, theta=1e4)),
                      ((gated_act(x, delta, "silu"),),
                       (ref.gated_act(x, delta, "silu"),))):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (add_rmsnorm.launches, qkv_rope.launches,
            gated_act.launches) == before


def test_wrappers_refuse_grad():
    x = torch.zeros(2, 8, dtype=BF16, requires_grad=True)
    w = torch.ones(8, dtype=BF16)
    with pytest.raises(RuntimeError, match="no backward"):
        add_rmsnorm(x, None, w, 1e-6)
    with pytest.raises(RuntimeError, match="no backward"):
        gated_act(x, x, "silu")


# ---------------------------------------------------------------------------
# which pass forward takes
# ---------------------------------------------------------------------------
class Recorder:
    """An ``ElementwiseFns`` whose passes count their calls and run the
    plain versions."""

    def __init__(self):
        self.calls = {"add_norm": 0, "qkv_rope": 0, "gated_act": 0}

    def _counted(self, name, fn):
        def call(*a, **kw):
            self.calls[name] += 1
            return fn(*a, **kw)
        return call

    def fns(self):
        return ElementwiseFns(self._counted("add_norm", ref.add_rmsnorm),
                              self._counted("qkv_rope", ref.qkv_rope),
                              self._counted("gated_act", ref.gated_act))


def _expected(cfg):
    """Each pass's calls in one forward that the bundle covers whole: two
    norms a slot and the final norm; RoPE per attention slot; the gated
    activation per MLP slot."""
    kinds = list(cfg.layer_period) * cfg.n_periods
    return {"add_norm": 2 * len(kinds) + 1,
            "qkv_rope": sum(m in (ATTN, ATTN_LOCAL) for m, _ in kinds),
            "gated_act": sum(f == MLP for _, f in kinds)}


def _run(cfg, *, as_cuda: bool, dtype=BF16, cached: bool = False,
         grad: bool = False, trained: bool = False, monkeypatch=None):
    """One forward (full-sequence, or a cached block decode through
    ``lane_block_forward``) of ``cfg`` on the CPU with a recording bundle;
    returns its call counts. ``grad``: grad mode on; ``trained``: the
    params require grad, as in a training step. ``as_cuda`` makes every
    tensor pass for a CUDA one (``Tensor.is_cuda`` patched), so that the
    cover's other conditions are tested here."""
    rec = Recorder()
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu", dtype=dtype)
    if trained:
        for t in torch.utils._pytree.tree_leaves(params):
            t.requires_grad_(True)
    tokens = torch.randint(0, cfg.vocab_size - 1, (2, 16 if cached else 8))
    if as_cuda:
        monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    with torch.set_grad_enabled(grad):
        if cached:
            spec = SamplerSpec(prompt_len=8, gen_len=8, block_size=4)
            cache = C.init_cache(cfg, 2, 16, device="cpu")
            lane_block_forward(params, tokens, torch.tensor([8, 12]), cache,
                               cfg=cfg, spec=spec, decode_attention_fn=None,
                               paged_decode_attention_fn=None,
                               elementwise_fns=rec.fns(), moe_per_row=True)
        else:
            T.forward(params, tokens, cfg=cfg, device="cpu",
                      elementwise_fns=rec.fns())
    return rec.calls


@pytest.mark.parametrize("arch", ["dream-7b", "llada-8b", "gemma-7b",
                                  "sdar-30b-a3b"])
@pytest.mark.parametrize("cached", [False, True], ids=["prefill", "cached"])
def test_forward_takes_every_pass_where_it_covers_the_input(arch, cached,
                                                            monkeypatch):
    """rmsnorm, RoPE, a gated silu (dream, llada) or tanh-gelu (gemma) MLP,
    bf16 CUDA tensors, grad off: every norm, every QKV (sdar's with its
    QK-norm) and every MLP (sdar has none: its FFNs are MoE)."""
    cfg = get_config(arch).reduced(dtype="bfloat16")
    got = _run(cfg, as_cuda=True, cached=cached, monkeypatch=monkeypatch)
    assert got == _expected(cfg)


def test_forward_takes_no_pass_for_the_recurrent_mixers(monkeypatch):
    """jamba: its norms fused, RoPE only in its attention slots, the gated
    activation only in its MLP (not MoE) slots; the Mamba mixers plain."""
    cfg = get_config("jamba-v0.1-52b").reduced(dtype="bfloat16")
    got = _run(cfg, as_cuda=True, monkeypatch=monkeypatch)
    want = _expected(cfg)
    assert got == want
    assert 0 < want["qkv_rope"] < cfg.n_layers
    assert 0 < want["gated_act"] < cfg.n_layers


def test_forward_takes_the_passes_in_grad_mode_without_a_gradient(
        monkeypatch):
    """Grad mode on but no tensor requiring grad (the engines' decode):
    nothing to carry a gradient through, so every pass is taken."""
    cfg = get_config("dream-7b").reduced(dtype="bfloat16")
    got = _run(cfg, as_cuda=True, grad=True, monkeypatch=monkeypatch)
    assert got == _expected(cfg)


@pytest.mark.parametrize("case", ["training", "cpu", "fp32"])
def test_forward_takes_the_plain_ops_off_the_cover(case, monkeypatch):
    """In a training forward (grad mode on, params requiring grad), for
    CPU tensors and for fp32 tensors the bundle is never called, whatever
    it holds."""
    cfg = get_config("dream-7b").reduced(
        dtype="float32" if case == "fp32" else "bfloat16")
    got = _run(cfg, as_cuda=case != "cpu", grad=case == "training",
               trained=case == "training",
               dtype=torch.float32 if case == "fp32" else BF16,
               monkeypatch=monkeypatch)
    assert got == {"add_norm": 0, "qkv_rope": 0, "gated_act": 0}


@pytest.mark.parametrize("arch", ["whisper-base", "rwkv6-1.6b"])
def test_forward_takes_the_plain_ops_for_layernorm_and_plain_gelu(
        arch, monkeypatch):
    """whisper (layernorm, sinusoidal positions, a plain gelu MLP) and rwkv6
    (layernorm, no positions, the channel mix): no pass at all."""
    cfg = get_config(arch).reduced(dtype="bfloat16")
    got = _run(cfg, as_cuda=True, monkeypatch=monkeypatch)
    assert got == {"add_norm": 0, "qkv_rope": 0, "gated_act": 0}


def test_the_bundles_carry_the_passes():
    """KERNELS carries the kernels' wrappers; PLAIN today's ops."""
    assert KERNELS.elementwise == ElementwiseFns(add_rmsnorm, qkv_rope,
                                                 gated_act)
    assert PLAIN.elementwise is None


# ---------------------------------------------------------------------------
# the kernels' names in the benchmark's device groups
# ---------------------------------------------------------------------------
def _global_names():
    src = CU.read_text()
    return re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                      r"(\w+)\s*\(", src)


def test_the_kernels_names_fall_under_other():
    """The benchmark files each kernel by its name: the passes' time is the
    model forward's elementwise time ("other"), none is a matmul, an
    attention, a select or an xent kernel."""
    names = _global_names()
    assert sorted(names) == ["add_rmsnorm_kernel", "gated_act_kernel",
                             "qkv_rope_kernel"]
    for name in names:
        # as the profiler prints them: demangled, with template arguments
        # and the parameter list
        printed = (f"void (anonymous namespace)::{name}<0>(__nv_bfloat16 "
                   "const*, __nv_bfloat16 const*, __nv_bfloat16*, long)")
        assert TR.group(name) == "other"
        assert TR.group(printed) == "other"
