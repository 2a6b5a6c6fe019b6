"""The plain reference of a dense decoder under CDLM's block-causal mask,
in float32 with TF32 off, computed layer by layer.

The model: token embedding; per layer rmsnorm, attention (q, k and v
projections with an optional bias, RoPE at the config's theta over the
half-split head dims, grouped-query or multi-head attention scaled by
1/sqrt(hd)), the output projection and the residual, rmsnorm, the SwiGLU
MLP (silu(x W_gate) * (x W_up), then W_down) and the residual; the final
rmsnorm and the untied head. The block-causal mask: the prompt is one
block that sees itself; a generated block sees the prompt, every block
before it and all of its own positions.

It reads the benchmark's weights, the tree ``bench/harness/weights.py``
draws from :func:`layout` (the same tensors the program serves), one
layer at a time cast to float32, and imports nothing of the program.

:func:`block_stats` runs, for each request, the prompt and the committed
blocks as the context, and any number of states of a block being decoded
(the canvas of the block before one refinement iteration: some positions
still the mask token), each against the context before its block. For
every row of every state it returns the largest logit, its token, the
log-sum-exp, and the logits of the tokens asked for in ``gather``.

``precision="fp8"`` rounds both operands of every matrix product
(projections, attention's scores and weighted sums, the head) to
float8 e4m3, activations by row and weights by output column, scaled to
the format's range: the control, one step below the served bfloat16.
"""
from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

F8_MAX = 448.0
ROWS = 1024          # rows of one chunk of the MLP, the head and attention


def layout(model: dict):
    """The weights' leaves as ``bench/harness/weights.py`` draws them, in
    the program's tree: ``embed`` (``tok``; the untied ``head``, (V, d)),
    ``final_norm`` and one ``(attn, mlp)`` slot stacked over layers
    (``wq`` (n, d, Hq hd), ``wk``/``wv`` (n, d, Kv hd), ``wo`` (n, Hq hd, d),
    the QKV bias where the config has one; ``wi_gate``/``wi_up``
    (n, d, f), ``wo`` (n, f, d)). Matrices std 1/sqrt(fan in) (the token
    embedding 0.02), biases std 0.1, norm weights 1 + 0.1 z: every part
    of a layer changes what it computes."""
    if [list(p) for p in model["layer_period"]] != [["attn", "mlp"]]:
        raise ValueError("a dense decoder of (attn, mlp) layers")
    if model.get("tie_embeddings"):
        raise ValueError("a dense decoder with an untied head")
    n, d, f = model["n_layers"], model["d_model"], model["d_ff"]
    V, hd = model["vocab_size"], model["head_dim"]
    nq, nkv = model["n_heads"] * hd, model["n_kv_heads"] * hd
    s = 1 / math.sqrt(d)
    slot = ("slots", 0)
    leaves = [(("embed", "tok"), (V, d), "normal", 0.02),
              (("embed", "head"), (V, d), "head", s),
              (("final_norm", "w"), (d,), "norm", 0.1),
              (slot + ("norm1", "w"), (n, d), "norm", 0.1),
              (slot + ("norm2", "w"), (n, d), "norm", 0.1),
              (slot + ("attn", "wq"), (n, d, nq), "normal", s),
              (slot + ("attn", "wk"), (n, d, nkv), "normal", s),
              (slot + ("attn", "wv"), (n, d, nkv), "normal", s),
              (slot + ("attn", "wo"), (n, nq, d), "normal", 1 / math.sqrt(nq)),
              (slot + ("mlp", "wi_gate"), (n, d, f), "normal", s),
              (slot + ("mlp", "wi_up"), (n, d, f), "normal", s),
              (slot + ("mlp", "wo"), (n, f, d), "normal", 1 / math.sqrt(f))]
    if model.get("qkv_bias"):
        leaves += [(slot + ("attn", "bq"), (n, nq), "normal", 0.1),
                   (slot + ("attn", "bk"), (n, nkv), "normal", 0.1),
                   (slot + ("attn", "bv"), (n, nkv), "normal", 0.1)]
    return leaves


def set_fp32() -> None:
    """float32 products in float32: no TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _f8(x: torch.Tensor, dim: int) -> torch.Tensor:
    scale = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / F8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _mm(a: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """a (..., k) @ w (k, n)."""
    if precision == "fp8":
        a, w = _f8(a, -1), _f8(w, 0)
    return a @ w


def _rms(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def _rope(x, pos, theta):
    """x (..., L, H, hd); pos (..., L)."""
    half = x.shape[-1] // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float64,
                                  device=x.device) / half)
    ang = (pos.to(torch.float64)[..., None] * inv).float()[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _layer(params, i: int, model: dict, precision: str) -> dict:
    slot = params["slots"][0]
    w = {f"{g}.{k}": v[i].float() for g in ("attn", "mlp")
         for k, v in slot[g].items()}
    w["norm1"] = slot["norm1"]["w"][i].float()
    w["norm2"] = slot["norm2"]["w"][i].float()
    return w


def _project(w, h, pos, model, precision):
    """q (..., L, Hq, hd), k and v (..., L, Kv, hd), RoPE applied."""
    hd, theta = model["head_dim"], model["rope_theta"]
    lead = h.shape[:-1]
    q = _mm(h, w["attn.wq"], precision)
    k = _mm(h, w["attn.wk"], precision)
    v = _mm(h, w["attn.wv"], precision)
    if "attn.bq" in w:
        q, k, v = q + w["attn.bq"], k + w["attn.bk"], v + w["attn.bv"]
    q = _rope(q.reshape(*lead, -1, hd), pos, theta)
    k = _rope(k.reshape(*lead, -1, hd), pos, theta)
    return q, k, v.reshape(*lead, -1, hd)


def _expand(kv, group: int):
    """(..., L, Kv, hd) -> (..., L, Kv * group, hd): query head h reads kv
    head h // group."""
    return kv.repeat_interleave(group, dim=-2)


def _softmax_pv(scores, vals, precision):
    """softmax over the last axis of scores (..., Lk), weights @ vals."""
    p = torch.softmax(scores, dim=-1)
    if precision == "fp8":
        p, vals = _f8(p, -1), _f8(vals, -2)
    return p @ vals


def _mlp(w, x, model, precision):
    out = torch.empty_like(x)
    flat, dst = x.reshape(-1, x.shape[-1]), out.view(-1, x.shape[-1])
    for i in range(0, flat.shape[0], ROWS):
        h = _rms(flat[i:i + ROWS], w["norm2"], model["norm_eps"])
        g = torch.nn.functional.silu(_mm(h, w["mlp.wi_gate"], precision))
        u = _mm(h, w["mlp.wi_up"], precision)
        dst[i:i + ROWS] = _mm(g * u, w["mlp.wo"], precision)
    return x + out


def _context_layer(w, x, pos, blk, model, precision):
    """One layer over the context rows (L, d) under the block-causal mask;
    returns (x, k, v) with k, v expanded to the query heads."""
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
    return _mlp(w, x, model, precision), k, v


def _state_layer(w, x, pos, limit, kc, vc, model, precision):
    """One layer over the states (S, B, d): each state's block sees the
    context rows below ``limit[s]`` and all of its own rows."""
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
    x = x + _mm(out.reshape(S, B, -1), w["attn.wo"], precision)
    return _mlp(w, x, model, precision)


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
            w = _layer(params, i, model, precision)
            for run in runs:
                run["xc"], kc, vc = _context_layer(
                    w, run["xc"], run["pos_c"], run["blk_c"], model,
                    precision)
                run["xs"] = _state_layer(w, run["xs"], run["pos_s"],
                                         run["limit"], kc, vc, model,
                                         precision)
            del w
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
