"""The decoder stack, ported from the JAX package's
``models/transformer.py``: each slot a mixer, ``ATTN``, ``ATTN_LOCAL`` (a
sliding window of ``cfg.sliding_window``), ``MAMBA`` (``models/mamba.py``)
or ``RWKV`` (``models/rwkv6.py``'s time mix), then an FFN, ``MLP``,
``MOE`` or ``RWKV_CM`` (the channel mix); rmsnorm or layernorm, RoPE or
(attention-free) no positions; whisper's encoder-decoder (sinusoidal
positions, a plain gelu MLP, cross attention in every decoder slot) and
internvl2's prefix embeddings.

A model is ``cfg.n_periods`` repeats of ``cfg.layer_period``; each slot's
params are stacked over periods and the stack runs as a Python loop over
periods (the JAX package scans it), each stacked leaf split once per
forward. ``forward`` covers:

- the full-sequence forward (prefill), in any mask mode;
- the cached block decode: a block of queries per lane against that lane's
  KV cache rows and recurrent state, with a per-lane ``cache_len`` and
  per-lane positions, so lanes of one batch may decode at different block
  offsets; the KV cache is dense or block-paged
  (``core.cache.PagedCache``; its state leaves are dense either way).

Per-slot emissions come back stacked over periods, ready for
``core.cache.commit_rows``: ``{"k", "v"}`` ``(n_periods, b, L, Kv, hd)``
of an attention slot (and, cache-less in an encoder-decoder, the cross
attention's ``{"ck", "cv"}`` over the encoder's rows), the state after
the forward's last token of a
Mamba slot (``conv``, ``ssm``) or an RWKV slot (``S``, ``tm_shift``,
``cm_shift``), or go period by period to the forward's ``emit``; the MoE
slots' load-balance losses come back summed as ``aux_loss``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import (
    ATTN,
    ATTN_LOCAL,
    MAMBA,
    MLP,
    MOE,
    RWKV_CM,
    ModelConfig,
    check_supported,
)
from repro_torch.core import masks
from repro_torch.kernels.decode_attn.ref import gather_pages
from repro_torch.models import layers as L
from repro_torch.models import mamba as MB
from repro_torch.models import moe as MO
from repro_torch.models import rwkv6 as R



class ModelOutput(NamedTuple):
    logits: Optional[torch.Tensor]  # (b, Lq, V) fp32; None without logits
    hidden: torch.Tensor            # (b, Lq, d) last hidden (post final norm)
    emissions: Optional[tuple]      # per slot its K/V or state, stacked
    #                                 over periods (None: given to emit)
    aux_loss: torch.Tensor          # MoE load-balance aux (fp32 scalar; 0
    #                                 without an MOE slot)


def unembed_matrix(params, cfg: ModelConfig) -> torch.Tensor:
    """The (V, d) matrix ``lm_head`` multiplies by, handed to the fused
    unembed + select kernel so decode never builds logits."""
    return L.unembed_w(params["embed"], cfg)


def _by_period(tree, n: int):
    """A tree whose leaves are stacked over ``n`` periods as ``n`` trees,
    each leaf split once with ``torch.unbind``. The backward of one unbind
    stacks the periods' gradients once; indexing ``leaf[p]`` in every
    period would fill and add a zero tensor of the whole stack per period
    instead (O(n^2) bytes per leaf)."""
    if isinstance(tree, dict):
        per_key = {k: _by_period(v, n) for k, v in tree.items()}
        return [{k: v[p] for k, v in per_key.items()} for p in range(n)]
    return torch.unbind(tree, 0)


def _fusable(*tensors) -> bool:
    """Whether the fused passes take these tensors (a pass's inputs, or the
    tensors its inputs are computed from): bf16 on a CUDA device, and no
    gradient to carry through them (the kernels have no backward): grad
    mode off, or none of them requiring grad, as in the engines' decode."""
    grad = torch.is_grad_enabled()
    return all(t.is_cuda and t.dtype == torch.bfloat16
               and not (grad and t.requires_grad)
               for t in tensors if t is not None)


def _add_norm(norm, x, delta, *, cfg: ModelConfig, ctx):
    """(x + delta, the norm of that sum); without ``delta``, (x, its norm).
    Every residual add of the stack is followed by a norm, so each add is
    folded into the norm after it: one fused pass where the forward's
    ``elementwise_fns`` cover it (rmsnorm, :func:`_fusable` tensors), the
    plain ops otherwise."""
    fns = ctx["elementwise_fns"]
    if (fns is not None and cfg.norm_type == "rmsnorm"
            and _fusable(x, delta, norm["w"])):
        return fns.add_norm(x, delta, norm["w"], cfg.norm_eps)
    if delta is not None:
        x = x + delta
    return x, L.apply_norm(norm, x, cfg)


def _project_qkv(params, h, *, cfg: ModelConfig, ctx):
    """q (b, L, Kv, G, hd), k and v (b, L, Kv, hd): the projections, their
    biases, a ``qk_norm`` config's per-head RMSNorm of q and k, and RoPE at
    ``ctx["q_pos"]``; the bias adds, the norms and the rotations in one
    fused pass where ``elementwise_fns`` cover them (RoPE, :func:`_fusable`
    tensors)."""
    fns = ctx["elementwise_fns"]
    b, n = h.shape[:2]
    keys = ("wq", "wk", "wv", "bq", "bk", "bv", "q_norm", "k_norm")
    if (fns is not None and cfg.pos_embed == "rope"
            and _fusable(h, *(params.get(k) for k in keys))):
        q, k, v = fns.qkv_rope(
            h @ params["wq"], h @ params["wk"], h @ params["wv"],
            params.get("bq"), params.get("bk"), params.get("bv"),
            ctx["q_pos"], head_dim=cfg.head_dim, theta=cfg.rope_theta,
            q_norm=params.get("q_norm"), k_norm=params.get("k_norm"),
            eps=cfg.norm_eps)
        shape = (b, n, cfg.n_kv_heads, cfg.head_dim)
        return (q.reshape(b, n, cfg.n_kv_heads, cfg.q_per_kv, cfg.head_dim),
                k.reshape(shape), v.reshape(shape))
    q = L.project_q(params, h, cfg)
    k, v = L.project_kv(params, h, cfg)
    if cfg.qk_norm:
        q = L.head_norm(q, params["q_norm"], cfg.norm_eps)
        k = L.head_norm(k, params["k_norm"], cfg.norm_eps)
    if cfg.pos_embed == "rope":
        q = L.rope(q, ctx["q_pos"], cfg.rope_theta)
        k = L.rope(k, ctx["q_pos"], cfg.rope_theta)
    return q, k, v


def _mlp(params, h, *, cfg: ModelConfig, ctx):
    """The MLP FFN; a gated silu or tanh-gelu one takes the fused
    ``act(g) * u`` pass where ``elementwise_fns`` cover it
    (:func:`_fusable` tensors)."""
    fns = ctx["elementwise_fns"]
    if (fns is not None and "wi_gate" in params
            and cfg.activation in ("silu", "gelu")
            and _fusable(h, params["wi_gate"], params["wi_up"])):
        return fns.gated_act(h @ params["wi_gate"], h @ params["wi_up"],
                             cfg.activation) @ params["wo"]
    return L.apply_mlp(params, h, cfg)


def _moe_grouped(params, h, *, cfg: ModelConfig, ctx):
    """The dropless grouped MoE (``moe_dispatch`` "grouped"): the experts
    through ``elementwise_fns.moe`` where the bundle is given and covers
    the input (on the CPU, where the wrapper takes the plain version, or
    :func:`_fusable` tensors), the plain version otherwise."""
    fns = ctx["elementwise_fns"]
    fused = fns is not None and (
        h.device.type == "cpu"
        or _fusable(h, params["wi_gate"], params["wi_up"], params["wo"]))
    return MO.apply_moe_grouped(params, h, cfg,
                                experts_fn=fns.moe if fused else None)


def _self_attention_slot(slot, h, *, cfg: ModelConfig, mixer: str, ctx):
    """The attention of the normed ``h``: returns (the out projection, to
    add to the residual stream, and the emission). An ``ATTN_LOCAL`` slot
    attends within ``cfg.sliding_window`` whatever ``use_long_window``
    says."""
    q, k, v = _project_qkv(slot["attn"], h, cfg=cfg, ctx=ctx)
    window = None
    if mixer == ATTN_LOCAL:
        window = cfg.sliding_window
    elif ctx["use_long_window"] and cfg.long_context_window:
        window = cfg.long_context_window
    scale, cap = L.attn_scale(cfg), cfg.attn_logit_softcap
    cache = ctx["cache_slot"]
    pages = ctx["pages"]

    # a cache_valid mask (the approx cache policies: stale rows anywhere
    # but the active block) takes the generic path, as in the reference
    kernel_ok = ctx["cache_valid"] is None
    if (cache is not None and pages is not None and kernel_ok
            and ctx["paged_decode_attention_fn"] is not None):
        # the paged decode attention kernel walks the page tables: no dense
        # view of the pool is built
        out = ctx["paged_decode_attention_fn"](
            q, cache["k"], cache["v"], k, v, pages, ctx["cache_lens"],
            scale=scale, softcap=cap, window=window).to(v.dtype)
    elif (cache is not None and pages is None and kernel_ok
            and ctx["decode_attention_fn"] is not None):
        # the decode attention kernel: cache rows below each lane's
        # cache_len plus the fresh in-block keys, one online softmax
        out = ctx["decode_attention_fn"](
            q, cache["k"], cache["v"], k, v, ctx["cache_lens"], scale=scale,
            softcap=cap, window=window).to(v.dtype)
    elif cache is None and ctx["prefill_attention_fn"] is not None:
        # the full-sequence kernel: visibility from row and column indices
        out = ctx["prefill_attention_fn"](
            q, k, v, mode=ctx["mode"], prompt_len=ctx["prompt_len"],
            block_size=ctx["block_size"], window=window, scale=scale,
            softcap=cap).to(v.dtype)
    else:
        q_pos = ctx["q_pos"]
        if cache is not None:
            ck, cv = cache["k"], cache["v"]
            if pages is not None:
                # the generic path reads the pool through the gathered
                # dense view; positions past cache_len are masked below
                ck, cv = gather_pages(ck, pages), gather_pages(cv, pages)
            b, S, Lq = ck.shape[0], ck.shape[1], k.shape[1]
            slots = torch.arange(S, device=h.device)
            k_all = torch.cat([ck, k.to(ck.dtype)], dim=1)
            v_all = torch.cat([cv, v.to(cv.dtype)], dim=1)
            kv_pos = torch.cat([slots.expand(b, S), q_pos.expand(b, Lq)], 1)
            cache_ok = (slots[None, :] < ctx["cache_lens"][:, None]
                        if kernel_ok else ctx["cache_valid"].expand(b, S))
            kv_valid = torch.cat(
                [cache_ok,
                 torch.ones((b, Lq), dtype=torch.bool, device=h.device)], 1)
        else:
            k_all, v_all, kv_pos, kv_valid = k, v, q_pos, None
        bias_fn = masks.make_bias_fn(mode=ctx["mode"],
                                     prompt_len=ctx["prompt_len"],
                                     block_size=ctx["block_size"],
                                     window=window)

        def bias_with_valid(qp, kp, valid):
            bias = bias_fn(qp, kp)
            if valid is not None:
                bias = torch.where(valid[..., None, :], bias,
                                   torch.full_like(bias, masks.NEG_INF))
            return bias

        out = L.attention_core(q, k_all, v_all, q_pos=q_pos, kv_pos=kv_pos,
                               kv_valid=kv_valid, bias_fn=bias_with_valid,
                               scale=scale, cap=cap)
    return L.out_proj(slot["attn"], out, cfg), {"k": k, "v": v}


def _cross_attention_slot(slot, x, *, cfg: ModelConfig, ctx):
    """Whisper's cross attention, between the mixer and the FFN: the
    decoder's queries against the encoder's K/V, read from the cache slot
    where it holds them (``ck``/``cv``, committed by the prefill) and
    projected from ``encoder_out`` otherwise, then emitted. Plain PyTorch
    (the reference's dense attention, no Pallas kernel). Returns (x,
    emission)."""
    h = L.apply_norm(slot["norm_cross"], x, cfg)
    q = L.project_q(slot["cross"], h, cfg)
    cache = ctx["cache_slot"]
    if cache is not None and "ck" in cache:
        ck, cv, em = cache["ck"], cache["cv"], {}
    else:
        ck, cv = L.project_kv(slot["cross"], ctx["encoder_out"], cfg)
        em = {"ck": ck, "cv": cv}
    out = L.cross_attention(q, ck, cv, scale=L.attn_scale(cfg))
    return x + L.out_proj(slot["cross"], out, cfg), em


def _apply_slot(slot, x, delta, *, cfg: ModelConfig, mixer: str, ffn: str,
                ctx, moe_per_row: bool):
    """One slot over the residual stream ``x`` with the previous slot's
    output ``delta`` not yet added (None: nothing to add): its mixer
    (attention, Mamba or the RWKV time mix, each reading its own leaves of
    the cache slot, zeros without a cache), an encoder-decoder's cross
    attention (layernorm, plain), then its FFN (MLP, MOE or the RWKV
    channel mix, which reads the *input* state's ``cm_shift``). The
    mixer's and the FFN's outputs are added to the stream by the norm after
    each (:func:`_add_norm`). Returns (x, the FFN's output
    still to add, emission, the MOE FFN's aux loss or None)."""
    cache = ctx["cache_slot"]
    aux = rwkv_in = None
    x, h = _add_norm(slot["norm1"], x, delta, cfg=cfg, ctx=ctx)
    if mixer in (ATTN, ATTN_LOCAL):
        y, em = _self_attention_slot(slot, h, cfg=cfg, mixer=mixer, ctx=ctx)
    elif mixer == MAMBA:
        state = (None if cache is None
                 else {"conv": cache["conv"], "ssm": cache["ssm"]})
        y, em = MB.mamba_forward(slot["mamba"], h, cfg, state=state)
    else:   # RWKV
        rwkv_in = (R.init_rwkv_state(cfg, x.shape[0], dtype=x.dtype,
                                     device=x.device) if cache is None
                   else {"S": cache["S"], "tm_shift": cache["tm_shift"],
                         "cm_shift": cache["cm_shift"]})
        y, em = R.time_mix(slot["rwkv_tm"], h, cfg, rwkv_in)
    if "cross" in slot and (ctx["encoder_out"] is not None
                            or (cache is not None and "ck" in cache)):
        x, cross_em = _cross_attention_slot(slot, x + y, cfg=cfg, ctx=ctx)
        y = None
        em.update(cross_em)
    x, h = _add_norm(slot["norm2"], x, y, cfg=cfg, ctx=ctx)
    if ffn == MOE and cfg.moe_dispatch == "grouped":
        y, aux = _moe_grouped(slot["moe"], h, cfg=cfg, ctx=ctx)
    elif ffn == MOE:
        y, aux = MO.apply_moe(slot["moe"], h, cfg, dropless=cache is not None,
                              moe_per_row=moe_per_row)
    elif ffn == RWKV_CM:      # after an RWKV mixer, as in every config
        y, cm_em = R.channel_mix(slot["rwkv_cm"], h, cfg, rwkv_in)
        em.update(cm_em)
    else:
        y = _mlp(slot["mlp"], h, cfg=cfg, ctx=ctx)
    return x, y, em, aux


def _run_stack(slots_params, x, *, cfg: ModelConfig, slot_kinds, n: int,
               ctx, cache, remat: bool, moe_per_row: bool, emit=None):
    """The ``n`` periods of ``slot_kinds`` over ``x``, each slot's params
    (and cache leaves) stacked over the periods. Returns (x, the last
    slot's output still to add (the final norm adds it), emissions stacked
    over periods per slot, the summed MoE aux loss). ``emit(p, ems)``,
    where given, takes period ``p``'s emissions as it makes them, and
    none are kept (None in their place)."""
    dev = x.device
    slots = [_by_period(slot_params, n) for slot_params in slots_params]
    cache_slots = (None if cache is None
                   else [_by_period(c, n) for c in cache])

    def period_body(x, delta, aux, p: int):
        ems = []
        for i, (mixer, ffn) in enumerate(slot_kinds):
            c = dict(ctx, cache_slot=None if cache is None
                     else cache_slots[i][p])
            x, delta, em, a = _apply_slot(slots[i][p], x, delta, cfg=cfg,
                                          mixer=mixer, ffn=ffn, ctx=c,
                                          moe_per_row=moe_per_row)
            if a is not None:
                aux = aux + a
            ems.append(em)
        return x, delta, aux, ems

    checkpointed = remat and torch.is_grad_enabled()
    emitted = [[] for _ in slot_kinds]
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    delta = None
    for p in range(n):
        if checkpointed:
            x, delta, aux, ems = checkpoint(period_body, x, delta, aux, p,
                                            use_reentrant=False)
        else:
            x, delta, aux, ems = period_body(x, delta, aux, p)
        if emit is not None:
            emit(p, tuple(ems))
            continue
        for i, em in enumerate(ems):
            emitted[i].append(em)
    if emit is not None:
        return x, delta, None, aux
    emissions = tuple({key: torch.stack([em[key] for em in ems])
                       for key in ems[0]} for ems in emitted)
    return x, delta, emissions, aux


def encode(params, frames, *, cfg: ModelConfig, prefill_attention_fn=None,
           elementwise_fns=None, remat: bool = False) -> torch.Tensor:
    """Whisper's encoder over ``frames`` (b, enc_len, d), in their dtype:
    sinusoidal positions at ``arange(enc_len)``, ``cfg.n_encoder_layers``
    bidirectional ``(ATTN, MLP)`` layers without a cache (self attention
    through ``prefill_attention_fn`` where given), then the encoder's
    final norm; ``elementwise_fns`` as in :func:`forward`. Returns the (b,
    enc_len, d) output every decoder layer's cross attention reads."""
    dev = frames.device
    enc_pos = torch.arange(frames.shape[1], device=dev)
    if cfg.pos_embed == "sinusoidal":
        frames = frames + L.sinusoidal_embedding(enc_pos, cfg.d_model).to(
            frames.dtype)
    ctx = dict(mode=masks.BIDIRECTIONAL, prompt_len=0, block_size=1,
               q_pos=enc_pos, cache_lens=None, cache_slot=None,
               cache_valid=None, pages=None, use_long_window=False,
               decode_attention_fn=None, paged_decode_attention_fn=None,
               prefill_attention_fn=prefill_attention_fn, encoder_out=None,
               elementwise_fns=elementwise_fns)
    x, delta, _, _ = _run_stack(params["encoder"]["slots"], frames, cfg=cfg,
                                slot_kinds=((ATTN, MLP),),
                                n=cfg.n_encoder_layers, ctx=ctx, cache=None,
                                remat=remat, moe_per_row=False)
    return _add_norm(params["encoder"]["final_norm"], x, delta, cfg=cfg,
                     ctx=ctx)[1]


def forward(params, tokens, *, cfg: ModelConfig, device="cuda",
            mode: str = masks.BIDIRECTIONAL, prompt_len: int = 0,
            block_size: int = 1, positions=None, prefix_embeds=None,
            encoder_embeds=None, cache=None, cache_len=None,
            cache_valid=None, use_long_window: bool = False,
            decode_attention_fn=None, paged_decode_attention_fn=None,
            prefill_attention_fn=None, elementwise_fns=None,
            remat: bool = False,
            logits_slice: Optional[Tuple[int, int]] = None,
            return_logits: bool = True,
            moe_per_row: bool = False, emit=None) -> ModelOutput:
    """Run the model.

    tokens: (b, L) int. ``prefix_embeds`` (b, n, d): stub-frontend
    embeddings (internvl2's patches) put in front of the token embeddings,
    in their dtype; they are part of the prompt for masking, so the
    caller's ``prompt_len`` counts them, and the outputs' rows are the
    prefix's then the tokens'. ``encoder_embeds`` (b, enc_len, d):
    whisper's frame embeddings (stub frontend), cast to the activations'
    dtype and run through the encoder: bidirectional, cache-less, over
    ``cfg.n_encoder_layers``, ending in its final norm; every decoder
    layer's cross attention reads its output, or, where the cache holds
    them, the committed ``ck``/``cv``. Sinusoidal positions are added to
    the decoder's input at its positions and to the encoder's at
    ``arange(enc_len)``.

    ``cache`` (a ``core.cache.init_cache`` tuple or a
    ``core.cache.PagedCache``) with ``cache_len`` (int, or (b,) per lane)
    runs the cached block decode: query i of lane j sits at
    ``cache_len[j] + i`` unless ``positions`` ((L,) or (b, L)) says
    otherwise. A ``PagedCache`` is read as page pools through its tables.
    ``cache_valid`` ((S,) bool), where given, says which cache rows the
    queries see in place of ``slots < cache_len`` (the approx cache
    policies: a stale cache whose only invalid rows are the active
    block's); such a forward takes the generic attention, since one
    ``cache_len`` per lane cannot express the mask.

    The attention of a forward is the generic masked attention unless a
    kernel is given: ``decode_attention_fn``
    (``kernels.decode_attn.decode_attention``-shaped) for cached forwards
    on a dense cache, ``paged_decode_attention_fn``
    (``kernels.decode_attn.paged_decode_attention``-shaped) for cached
    forwards on a paged one, ``prefill_attention_fn``
    (``kernels.block_attn.flash_block_attention``-shaped) for cache-less
    forwards at the default positions ``arange(L)`` (the kernel derives
    visibility from indices, so given ``positions`` take the generic
    path) and for the encoder. ``elementwise_fns``
    (``kernels.elementwise.ElementwiseFns``-shaped; None: the plain ops)
    are the fused passes between the matmuls: residual add + RMSNorm, QKV
    bias + RoPE and the gated silu / tanh-gelu activation, each taken only
    where it covers the input (rmsnorm, RoPE, a gated MLP, bf16 CUDA
    tensors with no gradient to carry) and the plain ops elsewhere
    (layernorm, plain gelu, the recurrent mixers, the capacity MoE's
    experts, training), whatever the bundle; its ``moe`` runs the experts
    of a ``moe_dispatch`` "grouped" config (the dropless grouped product).
    ``return_logits=False`` skips the lm_head
    (the fused-select decode reads ``hidden``); ``logits_slice=(s0, s1)``
    applies it to positions ``[s0, s1)`` only (the CDLM losses read
    generation-span logits). ``remat`` recomputes each layer period in
    the backward (``torch.utils.checkpoint``, as the JAX package's
    ``jax.checkpoint`` of the period body) when grad mode is on. The MoE
    slots of a cached forward size their expert buffers by the decode's
    bounded capacity (dropless), those of a cache-less one by the
    capacity factor, as the reference's defaults do (a "grouped" config's
    MoE drops nothing, in every forward). ``moe_per_row``
    gives each row of the batch its own expert capacity (as in
    ``models.moe.apply_moe``): the reference's per-lane forward.
    ``emit(p, ems)``, where given, takes each period's emissions (per slot,
    without the period axis) as the forward makes them, say to commit
    them (``core.cache.period_commit``), and the forward keeps none
    (``emissions`` None): a long prefill never holds every layer's K/V
    at once.
    """
    check_supported(cfg)
    dev = resolve_device(device)
    tokens = torch.as_tensor(tokens, device=dev)
    if params["embed"]["tok"].device != tokens.device:
        raise ValueError(f"params live on {params['embed']['tok'].device}, "
                         f"forward was asked to run on {tokens.device}")
    b = tokens.shape[0]
    x = L.embed_tokens(params["embed"], tokens, cfg)
    if prefix_embeds is not None:
        x = torch.cat([torch.as_tensor(prefix_embeds, device=dev).to(
            x.dtype), x], dim=1)
    Lq = x.shape[1]
    pages = None
    if cache is not None and not isinstance(cache, tuple):
        # a core.cache.PagedCache (not imported here: core.cache imports
        # the bridge, which imports this module)
        pages = cache.device_table()
        cache = cache.slots
    encoder_attention_fn = prefill_attention_fn
    if positions is not None:
        prefill_attention_fn = None
    cache_lens = None
    if cache is not None:
        cache_lens = torch.as_tensor(cache_len, dtype=torch.int32,
                                     device=dev).expand(b).contiguous()
    if positions is None:
        base = cache_lens[:, None] if cache is not None else 0
        positions = base + torch.arange(Lq, device=dev)
    positions = torch.as_tensor(positions, device=dev)
    if cfg.pos_embed == "sinusoidal":
        x = x + L.sinusoidal_embedding(positions, cfg.d_model).to(x.dtype)

    encoder_out = None
    if cfg.is_encoder_decoder and encoder_embeds is not None:
        encoder_out = encode(
            params, torch.as_tensor(encoder_embeds, device=dev).to(x.dtype),
            cfg=cfg, prefill_attention_fn=encoder_attention_fn,
            elementwise_fns=elementwise_fns, remat=remat)

    if cache_valid is not None:
        cache_valid = torch.as_tensor(cache_valid, dtype=torch.bool,
                                      device=dev)
    ctx = dict(mode=mode, prompt_len=prompt_len, block_size=block_size,
               q_pos=positions, cache_lens=cache_lens, cache_slot=None,
               cache_valid=cache_valid,
               pages=pages, use_long_window=use_long_window,
               decode_attention_fn=decode_attention_fn,
               paged_decode_attention_fn=paged_decode_attention_fn,
               prefill_attention_fn=prefill_attention_fn,
               encoder_out=encoder_out, elementwise_fns=elementwise_fns)
    x, delta, emissions, aux = _run_stack(
        params["slots"], x, cfg=cfg, slot_kinds=cfg.layer_period,
        n=cfg.n_periods, ctx=ctx, cache=cache, remat=remat,
        moe_per_row=moe_per_row, emit=emit)

    hidden = _add_norm(params["final_norm"], x, delta, cfg=cfg, ctx=ctx)[1]
    if not return_logits:
        return ModelOutput(logits=None, hidden=hidden, emissions=emissions,
                           aux_loss=aux)
    head_in = (hidden if logits_slice is None
               else hidden[:, logits_slice[0]:logits_slice[1]])
    return ModelOutput(logits=L.lm_head(params["embed"], head_in, cfg),
                       hidden=hidden, emissions=emissions, aux_loss=aux)
