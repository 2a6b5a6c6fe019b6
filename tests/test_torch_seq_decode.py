"""Sequence-parallel decode attention on ``torch.distributed``
(``repro_torch/parallel/seq_decode.py``) against the JAX package's
``shard_map`` version: four gloo ranks on the CPU, each holding a quarter
of the cache, against the reference on a (data 2, model 4) mesh of eight
forced host devices, on the same numpy inputs, at fp32 within 1e-5; per-
lane lengths against the port's plain decode attention; and the port's
forward with the sharded ``decode_attention_fn`` against its unsharded
forward (qwen2-0.5b and gemma2-27b reduced: a window and softcaps)."""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

pytest.importorskip("torch")

from _torch_dist import ROOT, run_ranks  # noqa: E402

ATOL = 1e-5
SHAPE = (2, 8, 2, 2, 16, 64)            # b, Bq, Kv, G, hd, S
# (cache_len, window, softcap): the reference test's two cases, a softcap,
# a cache_len on a shard edge (S/4 = 16 rows a rank) and cache_len 0
CASES = [(50, None, None), (50, 24, None), (50, None, 2.5), (32, None, None),
         (32, 24, 2.5), (0, None, None)]


def _inputs(path):
    b, Bq, Kv, G, hd, S = SHAPE
    rng = np.random.default_rng(0)
    arrs = {"q": rng.standard_normal((b, Bq, Kv, G, hd)),
            "kc": rng.standard_normal((b, S, Kv, hd)),
            "vc": rng.standard_normal((b, S, Kv, hd)),
            "kb": rng.standard_normal((b, Bq, Kv, hd)),
            "vb": rng.standard_normal((b, Bq, Kv, hd))}
    np.savez(path, **{k: v.astype(np.float32) for k, v in arrs.items()})


JAX = """
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.launch.mesh import make_tiny_mesh
from repro.parallel import make_sharded_decode_attention
d = np.load("inputs.npz")
mesh = make_tiny_mesh(data=2, model=4)
fn = make_sharded_decode_attention(mesh, batch_axis="data")
out = {}
for i, (clen, window, cap) in enumerate(json.loads(sys.argv[1])):
    with mesh:
        o = jax.jit(lambda *a: fn(*a, scale=0.25, softcap=cap,
                                  window=window))(
            d["q"], d["kc"], d["vc"], d["kb"], d["vb"], jnp.asarray(clen))
    out[f"case{i}"] = np.asarray(o)
np.savez("jax_out.npz", **out)
print("JAX_OK")
"""

PORT = """
import json
import numpy as np
from repro_torch.parallel import make_sharded_decode_attention
from repro_torch.kernels.decode_attn import ref
d = {k: torch.from_numpy(v) for k, v in np.load("inputs.npz").items()}
S = d["kc"].shape[1]
n = S // WORLD
rows = slice(RANK * n, (RANK + 1) * n)
fn = make_sharded_decode_attention(None, axis_size=WORLD, axis_rank=RANK)
out = {}
for i, (clen, window, cap) in enumerate(CASES):
    out[f"case{i}"] = fn(d["q"], d["kc"][:, rows], d["vc"][:, rows], d["kb"],
                         d["vb"], clen, scale=0.25, softcap=cap,
                         window=window).numpy()
# per-lane lengths, each lane's edge in another rank
lens = torch.tensor([50, 17], dtype=torch.int32)
for w in (None, 24):
    got = fn(d["q"], d["kc"][:, rows], d["vc"][:, rows], d["kb"], d["vb"],
             lens, scale=0.25, window=w)
    want = ref.decode_attention(d["q"], d["kc"], d["vc"], d["kb"], d["vb"],
                                lens, scale=0.25, window=w)
    out[f"lanes{w}"] = np.asarray((got - want).abs().max())
if RANK == 0:
    np.savez("port_out.npz", **out)
print("PORT_OK")
"""

FORWARD = """
import numpy as np
from repro_torch import tree as T
from repro_torch.bridge import init_params
from repro_torch.configs import get_config
from repro_torch.core import masks
from repro_torch.models import forward
from repro_torch.parallel import make_sharded_decode_attention
errs = {}
# cache_len a multiple of the block (8): the generic path's block-causal
# mask puts the queries in one block only then, as a decode step does
for name, S, clen in (("qwen2-0.5b", 64, 40), ("gemma2-27b", 128, 88)):
    cfg = get_config(name).reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(1)
    cache = tuple({k: torch.from_numpy(rng.standard_normal(
        (cfg.n_periods, 2, S, cfg.n_kv_heads, cfg.head_dim)).astype(
        np.float32)) for k in ("k", "v")} for _ in cfg.layer_period)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8)))
    kw = dict(cfg=cfg, device="cpu", mode=masks.BLOCK_CAUSAL, prompt_len=0,
              block_size=8, cache_len=clen)
    want = forward(params, tokens, cache=cache, **kw)
    n = S // WORLD
    local = tuple({k: v[:, :, RANK * n:(RANK + 1) * n] for k, v in
                   slot.items()} for slot in cache)
    got = forward(params, tokens, cache=local,
                  decode_attention_fn=make_sharded_decode_attention(
                      None, axis_size=WORLD, axis_rank=RANK), **kw)
    errs[name] = float((got.logits - want.logits).abs().max())
    errs[name + ":scale"] = float(want.logits.abs().max())
    errs[name + ":emissions"] = max(
        float((g - w).abs().max()) for g, w in zip(
            T.leaves(got.emissions), T.leaves(want.emissions)))
print(json.dumps(errs))
"""


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("seq_decode")
    _inputs(tmp / "inputs.npz")
    cases = json.dumps(CASES)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    jax_run = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(JAX), cases], cwd=tmp,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ports = run_ranks(f"CASES = {CASES!r}\n" + PORT, 4, tmp)
        fwd = run_ranks("import json\n" + FORWARD, 4, tmp)
        out, err = jax_run.communicate(timeout=300)
    finally:
        if jax_run.poll() is None:
            jax_run.kill()
    assert jax_run.returncode == 0 and "JAX_OK" in out, err
    assert all("PORT_OK" in o for o in ports)
    return (dict(np.load(tmp / "jax_out.npz")),
            dict(np.load(tmp / "port_out.npz")),
            [json.loads(o.strip().splitlines()[-1]) for o in fwd])


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[f"len{c}-win{w}-cap{s}" for c, w, s in CASES])
def test_sharded_decode_equals_jax(outputs, i):
    jax_out, port_out, _ = outputs
    want, got = jax_out[f"case{i}"], port_out[f"case{i}"]
    assert got.shape == want.shape == SHAPE[:5]
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_per_lane_lengths_equal_the_plain_decode(outputs):
    _, port_out, _ = outputs
    for w in (None, 24):
        assert float(port_out[f"lanes{w}"]) <= ATOL


@pytest.mark.parametrize("name", ["qwen2-0.5b", "gemma2-27b"])
def test_forward_with_the_sharded_decode_equals_unsharded(outputs, name):
    """Every rank's logits and emissions equal the unsharded forward's
    (the generic attention over the whole cache)."""
    for errs in outputs[2]:
        assert errs[name] <= ATOL * max(1.0, errs[name + ":scale"]), errs
        assert errs[name + ":emissions"] <= ATOL, errs
