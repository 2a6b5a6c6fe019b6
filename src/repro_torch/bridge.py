"""Params of the port: seeded random init, and conversion from the JAX
package's param tree or its npz checkpoints.

The port's params are the JAX tree's structure as nested dicts of tensors:
``{"embed": {"tok", ["head"]}, "final_norm": {"w"[, "b"]}, "slots": (slot,
...)}`` with every slot leaf stacked over ``cfg.n_periods``; a slot holds
``norm1`` and ``norm2`` (``w``, and ``b`` under layernorm), its mixer's
leaves, ``attn`` (an ``ATTN`` or ``ATTN_LOCAL`` mixer alike), ``mamba`` or
``rwkv_tm`` (an ``attn`` of a ``qk_norm`` config also holds ``q_norm``
and ``k_norm``, (hd,) per layer, stacked as ``(n, hd)``), an
encoder-decoder's ``cross`` attention (no bias) and
``norm_cross``, and its FFN's, ``mlp`` (``wi_gate``, ``wi_up``, ``wo``;
whisper's plain ``wi``, ``wo``), ``rwkv_cm`` or, for an ``MOE`` slot,
``moe`` (``router`` (d, E) fp32, ``wi_gate`` and ``wi_up`` (E, d, f),
``wo`` (E, f, d), and a ``shared`` gated FFN where the config has one).
Weights keep the JAX ``(in, out)`` layout except the untied head, which is
stored ``(V, d)`` (the transpose of the JAX ``(d, V)``) so that
``lm_head`` and the fused select kernel read the same rows for tied and
untied models. An encoder-decoder (whisper) also holds ``"encoder":
{"slots": (slot,), "final_norm"}``, one ``(ATTN, MLP)`` slot stacked over
``cfg.n_encoder_layers``.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import (
    MAMBA,
    MOE,
    RWKV,
    RWKV_CM,
    ModelConfig,
    check_supported,
)
from repro_torch.models import mamba as MB
from repro_torch.models import rwkv6 as RW

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name) -> torch.dtype:
    """``ModelConfig.dtype`` string (or a torch dtype) -> torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    return _DTYPES[str(name)]


def _ffn(n: int, d: int, f: int, lead=()):
    """A gated FFN's leaves, stacked over ``n`` periods (and ``lead``)."""
    return {"wi_gate": ((n, *lead, d, f), 1 / math.sqrt(d)),
            "wi_up": ((n, *lead, d, f), 1 / math.sqrt(d)),
            "wo": ((n, *lead, f, d), 1 / math.sqrt(f))}


def _mamba(cfg: ModelConfig, n: int):
    """A Mamba mixer's leaves (``models/mamba.py``), as the reference's
    ``init_mamba`` draws them."""
    d, N, dc = cfg.d_model, cfg.mamba_d_state, cfg.mamba_d_conv
    e, r = MB.d_inner(cfg), MB.dt_rank(cfg)
    return {"in_proj": ((n, d, 2 * e), 1 / math.sqrt(d)),
            "conv_w": ((n, dc, e), 1 / math.sqrt(dc)),
            "conv_b": ((n, e), "zeros"),
            "x_proj": ((n, e, r + 2 * N), 1 / math.sqrt(e)),
            "dt_proj_w": ((n, r, e), 1 / math.sqrt(r)),
            # softplus^-1(0.01)
            "dt_proj_b": ((n, e), ("full", math.log(math.expm1(0.01)))),
            "A_log": ((n, e, N), "log_arange", torch.float32),
            "D": ((n, e), "ones", torch.float32),
            "out_proj": ((n, e, d), 1 / math.sqrt(e))}


def _rwkv_time_mix(cfg: ModelConfig, n: int):
    """An RWKV time mix's leaves (``models/rwkv6.py``), as the reference's
    ``init_time_mix`` draws them; the decay's and the group norm's fp32."""
    d, hs = cfg.d_model, cfg.rwkv_head_size
    H, lora = RW.n_rwkv_heads(cfg), max(32, cfg.d_model // 16)
    half = ((n, d), ("full", 0.5))
    return {"mu_r": half, "mu_k": half, "mu_v": half, "mu_w": half,
            "mu_g": half,
            **{w: ((n, d, d), 1 / math.sqrt(d))
               for w in ("wr", "wk", "wv", "wg", "wo")},
            "w0": ((n, d), ("full", -6.0), torch.float32),
            "wa": ((n, d, lora), 1 / math.sqrt(d)),
            "wb": ((n, lora, d), 0.1 / math.sqrt(lora)),
            "u": ((n, d), 0.1, torch.float32),
            "ln_w": ((n, H, hs), "ones", torch.float32),
            "ln_b": ((n, H, hs), "zeros", torch.float32)}


def _rwkv_channel_mix(cfg: ModelConfig, n: int):
    d, f = cfg.d_model, cfg.d_ff
    return {"mu_k": ((n, d), ("full", 0.5)), "mu_r": ((n, d), ("full", 0.5)),
            "wk": ((n, d, f), 1 / math.sqrt(d)),
            "wv": ((n, f, d), 1 / math.sqrt(f)),
            "wr": ((n, d, d), 1 / math.sqrt(d))}


def _specs(cfg: ModelConfig):
    """Nested dict of leaf -> (shape, init[, dtype]) with init one of
    "ones", "zeros", ``("full", value)``, "log_arange" (Mamba's ``A_log``:
    ``log(1..N)`` along the last axis) or a normal's standard deviation;
    the distributions of the JAX package's ``init_model`` (dense_init:
    std = 1/sqrt(fan_in); an expert's matrices 1/sqrt(d) in and
    1/sqrt(moe_d_ff) out). A third element pins the leaf's dtype whatever
    the model's dtype, as in the reference: the MoE router, Mamba's
    ``A_log`` and ``D``, RWKV's ``w0``, ``u``, ``ln_w`` and ``ln_b`` are
    fp32."""
    check_supported(cfg)
    d, hd, n = cfg.d_model, cfg.head_dim, cfg.n_periods
    nq, nkv, V = cfg.n_heads * hd, cfg.n_kv_heads * hd, cfg.vocab_size

    def norm(lead):
        spec = {"w": ((*lead, d), "ones")}
        if cfg.norm_type == "layernorm":
            spec["b"] = ((*lead, d), "zeros")
        return spec

    def mlp(n):
        if cfg.activation == "gelu_plain":     # whisper: not gated
            return {"wi": ((n, d, cfg.d_ff), 1 / math.sqrt(d)),
                    "wo": ((n, cfg.d_ff, d), 1 / math.sqrt(cfg.d_ff))}
        return _ffn(n, d, cfg.d_ff)

    def attention(n, bias: bool, qk_norm: bool = False):
        a = {"wq": ((n, d, nq), 1 / math.sqrt(d)),
             "wk": ((n, d, nkv), 1 / math.sqrt(d)),
             "wv": ((n, d, nkv), 1 / math.sqrt(d)),
             "wo": ((n, nq, d), 1 / math.sqrt(nq))}
        if bias:
            a.update(bq=((n, nq), "zeros"), bk=((n, nkv), "zeros"),
                     bv=((n, nkv), "zeros"))
        if qk_norm:
            a.update(q_norm=((n, hd), "ones"), k_norm=((n, hd), "ones"))
        return a

    def slot(mixer, ffn):
        s = {"norm1": norm((n,)), "norm2": norm((n,))}
        if mixer == MAMBA:
            s["mamba"] = _mamba(cfg, n)
        elif mixer == RWKV:
            s["rwkv_tm"] = _rwkv_time_mix(cfg, n)
        else:
            s["attn"] = attention(n, cfg.qkv_bias, cfg.qk_norm)
        if cfg.is_encoder_decoder:
            # cross attention: no q/k/v bias, as the reference's
            s["cross"] = attention(n, False)
            s["norm_cross"] = norm((n,))
        if ffn == MOE:
            f, E = cfg.moe_d_ff, cfg.n_experts
            s["moe"] = {"router": ((n, d, E), 1 / math.sqrt(d),
                                   torch.float32),
                        **_ffn(n, d, f, (E,))}
            if cfg.n_shared_experts:
                s["moe"]["shared"] = _ffn(n, d, f * cfg.n_shared_experts)
        elif ffn == RWKV_CM:
            s["rwkv_cm"] = _rwkv_channel_mix(cfg, n)
        else:
            s["mlp"] = mlp(n)
        return s

    embed = {"tok": ((V, d), 0.02)}
    if not cfg.tie_embeddings:
        embed["head"] = ((V, d), 1 / math.sqrt(d))
    specs = {"embed": embed, "final_norm": norm(()),
             "slots": tuple(slot(*kinds) for kinds in cfg.layer_period)}
    if cfg.is_encoder_decoder:
        # whisper's encoder: one (ATTN, MLP) slot over its own layers
        ne = cfg.n_encoder_layers
        specs["encoder"] = {
            "slots": ({"norm1": norm((ne,)), "norm2": norm((ne,)),
                       "attn": attention(ne, cfg.qkv_bias),
                       "mlp": mlp(ne)},),
            "final_norm": norm(())}
    return specs


def _leaf_dtype(spec, dt):
    return spec[2] if len(spec) > 2 else dt


def _map(fn, spec, *trees):
    if isinstance(spec, dict):
        return {k: _map(fn, spec[k], *(t[k] for t in trees)) for k in spec}
    if isinstance(spec, tuple) and isinstance(spec[0], dict):
        return tuple(_map(fn, s, *(t[i] for t in trees))
                     for i, s in enumerate(spec))
    return fn(spec, *trees)


#: elements of one fp32 draw of :func:`init_params` (1 GiB)
DRAW_CHUNK = 1 << 28


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda", dtype=None):
    """Seeded random params, drawn (in fp32, on the generator's device) from
    the distributions of the JAX package's ``init_model``. The numbers are
    not JAX's: tests that compare the two build params with numpy and pass
    them through :func:`params_from_jax`.

    Each leaf is allocated in its own dtype; a leaf of more than
    ``DRAW_CHUNK`` elements is drawn in chunks of that many and cast into
    it chunk by chunk, so no fp32 copy of a large leaf exists (gemma2-27b's
    stacked FFN leaf is 7.8 GB in bf16)."""
    dev = resolve_device(device)
    dt = torch_dtype(dtype or cfg.dtype)

    def randn(n):
        return torch.randn(n, generator=generator, device=generator.device)

    def draw(spec):
        shape, init = spec[:2]
        leaf_dt = _leaf_dtype(spec, dt)
        if init == "ones":
            return torch.ones(shape, dtype=leaf_dt, device=dev)
        if init == "zeros":
            return torch.zeros(shape, dtype=leaf_dt, device=dev)
        if isinstance(init, tuple):                 # ("full", value)
            return torch.full(shape, init[1], dtype=leaf_dt, device=dev)
        if init == "log_arange":
            col = torch.arange(1, shape[-1] + 1, dtype=torch.float32,
                               device=dev).log()
            return col.expand(shape).to(leaf_dt).contiguous()
        n = math.prod(shape)
        if n <= DRAW_CHUNK:
            return (randn(shape) * init).to(device=dev, dtype=leaf_dt)
        out = torch.empty(shape, dtype=leaf_dt, device=dev)
        flat = out.view(-1)
        for i in range(0, n, DRAW_CHUNK):
            m = min(DRAW_CHUNK, n - i)
            flat[i:i + m] = (randn(m) * init).to(device=dev, dtype=leaf_dt)
        return out

    return _map(draw, _specs(cfg))


def _nest(flat: Mapping[str, np.ndarray]):
    """Flat ``checkpoint/io.py`` keys ("slots/0/attn/wq") -> nested tree."""
    tree: Dict = {}
    for key, val in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = val

    def tuples(node):
        if "slots" in node:
            node["slots"] = tuple(node["slots"][str(i)]
                                  for i in range(len(node["slots"])))

    tuples(tree)
    if "encoder" in tree:
        tuples(tree["encoder"])
    return tree


def params_from_jax(tree_or_npz, cfg: ModelConfig, device="cuda",
                    dtype=None):
    """The port's params from the JAX param tree (leaves as numpy arrays) or
    from the flat ``"embed/tok"``, ``"slots/0/attn/wq"``, ... keys of a
    ``checkpoint/io.py`` npz. Shapes are checked against ``cfg``."""
    dev = resolve_device(device)
    dt = torch_dtype(dtype or cfg.dtype)
    tree = tree_or_npz
    if "embed/tok" in tree:
        tree = _nest({k: tree[k] for k in tree})

    def convert(spec, leaf):
        arr = np.asarray(leaf)
        if arr.dtype.name == "bfloat16":   # numpy cannot hand bf16 to torch
            arr = arr.astype(np.float32)
        return torch.tensor(arr)

    out = _map(convert, _specs(cfg), tree)
    if not cfg.tie_embeddings:
        out["embed"]["head"] = out["embed"]["head"].t()   # (d, V) -> (V, d)

    def place(spec, leaf):
        if tuple(leaf.shape) != spec[0]:
            raise ValueError(f"param shape {tuple(leaf.shape)} does not "
                             f"match {cfg.name}'s {spec[0]}")
        return leaf.to(device=dev, dtype=_leaf_dtype(spec, dt)).contiguous()

    return _map(place, _specs(cfg), out)


def param_count(params) -> int:
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    if isinstance(params, tuple):
        return sum(param_count(v) for v in params)
    return params.numel()


def lora_from_jax(lora, device="cuda", dtype=None):
    """The port's LoRA adapters from a JAX ``models/lora.py`` tree
    (``{"slots/0/attn/wq": {"a", "b"}}``, leaves as numpy arrays); the
    layouts are the same. ``dtype`` defaults to each leaf's own."""
    dev = resolve_device(device)

    def convert(leaf):
        arr = np.asarray(leaf)
        if arr.dtype.name == "bfloat16":
            arr = arr.astype(np.float32)
            dt = torch.bfloat16
        else:
            dt = None
        return torch.tensor(arr).to(device=dev,
                                    dtype=torch_dtype(dtype) if dtype
                                    else dt)

    return {name: {k: convert(v) for k, v in ab.items()}
            for name, ab in lora.items()}
