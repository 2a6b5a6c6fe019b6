"""The plain reference of a Qwen3-MoE decoder (SDAR-30B-A3B) under CDLM's
block-causal mask, in float32 with TF32 off, computed layer by layer.

The model: token embedding; per layer rmsnorm, attention (q, k and v
projections without bias; each head of q and of k RMS-normed over its
head_dim values by its own (hd,) weight, the QK-norm; RoPE at the config's
theta over the half-split head dims; grouped-query attention scaled by
1/sqrt(hd)), the output projection and the residual, rmsnorm, the mixture
of experts and the residual; the final rmsnorm and the untied head. The
mixture: the router's logits ``h W_r`` over the E experts, their softmax in
float32, each token's top k experts with those probabilities renormalised
to sum to 1 as its gates, and the token's output the gates' sum of its
experts' SwiGLU FFNs, silu(h W_gate[e]) * (h W_up[e]) W_down[e] (ties between
probabilities go to the lower expert index); every choice of every token
is computed (no capacity, nothing dropped), routed on
the reference's own float32 logits. The block-causal mask: the prompt is
one block that sees itself; a generated block sees the prompt, every block
before it and all of its own positions.

It reads the benchmark's weights, the tree ``bench/harness/weights.py``
draws from :func:`layout` (the same tensors the program serves), one layer
at a time cast to float32 (the experts one at a time, each once a layer
for the rows of every request), and imports nothing
of the program. The router is drawn in the served dtype like every other
leaf (the program keeps its own init's router in float32; both compute
its product and softmax in float32). Its helpers (the fp8 rounding, the
norm, RoPE, the attention's grouped heads and softmax) are the dense
reference's (``dense_decoder.py``), loaded from beside this file.

:func:`block_stats` has the dense reference's signature and returns the
same numbers. ``precision="fp8"`` rounds both operands of every matrix
product (projections, the router, the experts, attention's scores and
weighted sums, the head) to float8 e4m3, activations by row and weights by
output column, scaled to the format's range: the control, one step below
the served bfloat16.
"""
from __future__ import annotations

import importlib.util
import math
import sys
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch


def _dense():
    """``dense_decoder.py`` beside this file, under the name the harness
    gives it."""
    name = "bench_reference_dense_decoder"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, Path(__file__).with_name("dense_decoder.py"))
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
    return sys.modules[name]


_D = _dense()
ROWS = _D.ROWS
set_fp32 = _D.set_fp32
_f8, _mm, _rms, _rope, _expand, _softmax_pv = (
    _D._f8, _D._mm, _D._rms, _D._rope, _D._expand, _D._softmax_pv)


def layout(model: dict):
    """The weights' leaves in the program's tree: ``embed`` (``tok``; the
    untied ``head``, (V, d)), ``final_norm`` and one ``(attn, moe)`` slot
    stacked over layers (``wq`` (n, d, Hq hd), ``wk``/``wv`` (n, d, Kv hd),
    ``wo`` (n, Hq hd, d), ``q_norm``/``k_norm`` (n, hd); ``router``
    (n, d, E), ``wi_gate``/``wi_up`` (n, E, d, f), ``wo`` (n, E, f, d)).
    Matrices std 1/sqrt(fan in) (the token embedding 0.02), norm weights
    1 + 0.1 z: every part of a layer changes what it computes."""
    if [list(p) for p in model["layer_period"]] != [["attn", "moe"]]:
        raise ValueError("a MoE decoder of (attn, moe) layers")
    if (model.get("tie_embeddings") or model.get("qkv_bias")
            or not model.get("qk_norm")
            or model.get("moe_dispatch") != "grouped"
            or model.get("n_shared_experts", 0)):
        raise ValueError("a MoE decoder with an untied head, QK-norm, no "
                         "bias, no shared expert, every choice computed")
    n, d, f = model["n_layers"], model["d_model"], model["moe_d_ff"]
    V, hd, E = model["vocab_size"], model["head_dim"], model["n_experts"]
    nq, nkv = model["n_heads"] * hd, model["n_kv_heads"] * hd
    s = 1 / math.sqrt(d)
    slot = ("slots", 0)
    return [(("embed", "tok"), (V, d), "normal", 0.02),
            (("embed", "head"), (V, d), "head", s),
            (("final_norm", "w"), (d,), "norm", 0.1),
            (slot + ("norm1", "w"), (n, d), "norm", 0.1),
            (slot + ("norm2", "w"), (n, d), "norm", 0.1),
            (slot + ("attn", "wq"), (n, d, nq), "normal", s),
            (slot + ("attn", "wk"), (n, d, nkv), "normal", s),
            (slot + ("attn", "wv"), (n, d, nkv), "normal", s),
            (slot + ("attn", "wo"), (n, nq, d), "normal", 1 / math.sqrt(nq)),
            (slot + ("attn", "q_norm"), (n, hd), "norm", 0.1),
            (slot + ("attn", "k_norm"), (n, hd), "norm", 0.1),
            (slot + ("moe", "router"), (n, d, E), "normal", s),
            (slot + ("moe", "wi_gate"), (n, E, d, f), "normal", s),
            (slot + ("moe", "wi_up"), (n, E, d, f), "normal", s),
            (slot + ("moe", "wo"), (n, E, f, d), "normal", 1 / math.sqrt(f))]


def _layer(params, i: int) -> dict:
    """Layer i's weights in float32, but the experts', which stay where
    they are (cast one expert at a time)."""
    slot = params["slots"][0]
    w = {f"attn.{k}": v[i].float() for k, v in slot["attn"].items()}
    w["norm1"] = slot["norm1"]["w"][i].float()
    w["norm2"] = slot["norm2"]["w"][i].float()
    w["router"] = slot["moe"]["router"][i].float()
    w["experts"] = tuple(slot["moe"][k][i]
                         for k in ("wi_gate", "wi_up", "wo"))
    return w


def _project(w, h, pos, model, precision):
    """q (..., L, Hq, hd), k and v (..., L, Kv, hd): QK-norm, then RoPE."""
    hd, theta, eps = model["head_dim"], model["rope_theta"], model["norm_eps"]
    lead = h.shape[:-1]
    q = _mm(h, w["attn.wq"], precision).reshape(*lead, -1, hd)
    k = _mm(h, w["attn.wk"], precision).reshape(*lead, -1, hd)
    v = _mm(h, w["attn.wv"], precision).reshape(*lead, -1, hd)
    q = _rope(_rms(q, w["attn.q_norm"], eps), pos, theta)
    k = _rope(_rms(k, w["attn.k_norm"], eps), pos, theta)
    return q, k, v


def _experts(w, h, model, precision):
    """The mixture over the normed rows h (r, d): each row's top k experts
    of its own float32 router softmax, gates renormalised, every choice's
    SwiGLU FFN weighted by its gate and summed."""
    k = model["experts_per_token"]
    probs = torch.softmax(_mm(h, w["router"], precision), dim=-1)
    # ties to the lower expert index (as jax.lax.top_k breaks them)
    top, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    top, ids = top[:, :k], ids[:, :k]
    gates = top / top.sum(-1, keepdim=True)
    wg, wu, wo = w["experts"]
    out = torch.zeros_like(h)
    for e in torch.unique(ids).tolist():
        chose = ids == e                              # (r, k)
        rows = chose.any(-1).nonzero().squeeze(-1)
        x = h[rows]
        g = torch.nn.functional.silu(_mm(x, wg[e].float(), precision))
        y = _mm(g * _mm(x, wu[e].float(), precision), wo[e].float(),
                precision)
        out[rows] += (gates[rows] * chose[rows]).sum(-1, keepdim=True) * y
    return out


def _moe(w, xs, model, precision):
    """Each of ``xs`` plus the mixture of its normed rows, the rows of all
    at once (each expert's weights cast once a layer)."""
    flat = torch.cat([x.reshape(-1, x.shape[-1]) for x in xs])
    h = _rms(flat, w["norm2"], model["norm_eps"])
    out = _experts(w, h, model, precision)
    sizes = [x.numel() // x.shape[-1] for x in xs]
    return [x + o.view(x.shape) for x, o in zip(xs, out.split(sizes))]


def _context_attn(w, x, pos, blk, model, precision):
    """One layer's attention over the context rows (L, d) under the
    block-causal mask, added to x; returns (x, k, v) with k, v expanded to
    the query heads. The layer's MoE follows (:func:`_moe`)."""
    H = model["n_heads"]
    G = H // model["n_kv_heads"]
    scale = 1 / math.sqrt(model["head_dim"])
    h = _rms(x, w["norm1"], model["norm_eps"])
    q, k, v = _project(w, h, pos, model, precision)
    k, v = _expand(k, G), _expand(v, G)
    kt, vt = k.permute(1, 2, 0), v.permute(1, 0, 2)        # (H, hd, L), (H, L, hd)
    if precision == "fp8":
        kt = _f8(kt, -2)
    out = torch.empty_like(q)
    for i in range(0, x.shape[0], ROWS):
        qi = q[i:i + ROWS].permute(1, 0, 2)               # (H, r, hd)
        if precision == "fp8":
            qi = _f8(qi, -1)
        s = (qi @ kt) * scale                             # (H, r, L)
        vis = blk[None, :] <= blk[i:i + ROWS, None]
        s = s.masked_fill(~vis, -math.inf)
        out[i:i + ROWS] = _softmax_pv(s, vt, precision).permute(1, 0, 2)
    x = x + _mm(out.reshape(x.shape[0], -1), w["attn.wo"], precision)
    return x, k, v


def _state_attn(w, x, pos, limit, kc, vc, model, precision):
    """One layer's attention over the states (S, B, d), added to x: each
    state's block sees the context rows below ``limit[s]`` and all of its
    own rows. The layer's MoE follows (:func:`_moe`)."""
    H = model["n_heads"]
    G = H // model["n_kv_heads"]
    scale = 1 / math.sqrt(model["head_dim"])
    S, B = x.shape[:2]
    h = _rms(x, w["norm1"], model["norm_eps"])
    q, k, v = _project(w, h, pos, model, precision)
    k, v = _expand(k, G), _expand(v, G)                  # (S, B, H, hd)
    kct, vct = kc.permute(1, 2, 0), vc.permute(1, 0, 2)  # (H, hd, L), (H, L, hd)
    if precision == "fp8":
        kct = _f8(kct, -2)
    L = kc.shape[0]
    cols = torch.arange(L, device=x.device)
    out = torch.empty_like(q)
    step = max(1, ROWS // B)
    for i in range(0, S, step):
        qi = q[i:i + step].permute(0, 2, 1, 3)           # (s, H, B, hd)
        ki = k[i:i + step].permute(0, 2, 3, 1)           # (s, H, hd, B)
        vi = v[i:i + step].permute(0, 2, 1, 3)           # (s, H, B, hd)
        if precision == "fp8":
            qi, ki = _f8(qi, -1), _f8(ki, -2)
        sc = (qi @ kct[None]) * scale                    # (s, H, B, L)
        vis = cols[None, :] < limit[i:i + step, None]    # (s, L)
        sc = sc.masked_fill(~vis[:, None, None, :], -math.inf)
        so = (qi @ ki) * scale                           # (s, H, B, B)
        p = torch.softmax(torch.cat([sc, so], dim=-1), dim=-1)
        pc, po = p[..., :L], p[..., L:]
        if precision == "fp8":
            pc, po = _f8(pc, -1), _f8(po, -1)
            vcq, viq = _f8(vct, -2), _f8(vi, -2)
        else:
            vcq, viq = vct, vi
        o = pc @ vcq[None] + po @ viq                    # (s, H, B, hd)
        out[i:i + step] = o.permute(0, 2, 1, 3)
    return x + _mm(out.reshape(S, B, -1), w["attn.wo"], precision)


def block_stats(params, model: dict, requests: List[dict], *,
                precision: str = "fp32",
                gather: Optional[List[np.ndarray]] = None) -> List[dict]:
    """``requests``: dicts with ``prompt`` (P,), ``context`` (the committed
    blocks the states see, flat), ``states`` (S, B) and ``state_block``
    (S,): the block index each state decodes. ``gather[r]``: (S, B, k)
    token ids whose logits to return. Returns per request ``max``,
    ``argmax``, ``lse`` (S, B) and ``gathered`` (S, B, k), on the host."""
    set_fp32()
    dev = params["embed"]["tok"].device
    P = len(requests[0]["prompt"])
    B = requests[0]["states"].shape[1]
    eps = model["norm_eps"]
    runs = []
    with torch.no_grad():
        tok = params["embed"]["tok"]
        for r in requests:
            ids = torch.as_tensor(np.concatenate([r["prompt"], r["context"]]),
                                  device=dev)
            st = torch.as_tensor(r["states"], device=dev)
            sb = torch.as_tensor(r["state_block"], device=dev)
            pos_c = torch.arange(len(ids), device=dev)
            runs.append({
                "xc": tok[ids].float(), "pos_c": pos_c,
                "blk_c": torch.where(pos_c < P, -1,
                                     torch.div(pos_c - P, B,
                                               rounding_mode="floor")),
                "xs": tok[st].float(),
                "pos_s": P + B * sb[:, None] + torch.arange(B, device=dev),
                "limit": P + B * sb})
        for i in range(model["n_layers"]):
            w = _layer(params, i)
            for run in runs:
                run["xc"], kc, vc = _context_attn(
                    w, run["xc"], run["pos_c"], run["blk_c"], model,
                    precision)
                run["xs"] = _state_attn(w, run["xs"], run["pos_s"],
                                        run["limit"], kc, vc, model,
                                        precision)
                del kc, vc
            # every run's rows through the layer's experts at once
            xs = _moe(w, [x for run in runs for x in (run["xc"], run["xs"])],
                      model, precision)
            for j, run in enumerate(runs):
                run["xc"], run["xs"] = xs[2 * j], xs[2 * j + 1]
            del w, xs
        head = params["embed"]["head"].float().t()               # (d, V)
        fnorm = params["final_norm"]["w"].float()
        out = []
        for j, run in enumerate(runs):
            xs = run["xs"]
            S = xs.shape[0]
            flat = xs.reshape(S * B, -1)
            g = None if gather is None else torch.as_tensor(
                gather[j], device=dev).reshape(S * B, -1)
            mx, am, lse, ga = [], [], [], []
            for a in range(0, S * B, ROWS):
                h = _rms(flat[a:a + ROWS], fnorm, eps)
                lg = _mm(h, head, precision)
                m, arg = lg.max(dim=-1)
                mx.append(m)
                am.append(arg)
                lse.append(torch.logsumexp(lg, dim=-1))
                if g is not None:
                    ga.append(lg.gather(1, g[a:a + ROWS]))
            res = {"max": torch.cat(mx).reshape(S, B).cpu().numpy(),
                   "argmax": torch.cat(am).reshape(S, B).cpu().numpy(),
                   "lse": torch.cat(lse).reshape(S, B).cpu().numpy()}
            if g is not None:
                res["gathered"] = torch.cat(ga).reshape(S, B, -1).cpu().numpy()
            out.append(res)
        del head
    return out
