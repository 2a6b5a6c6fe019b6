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
``cm_shift``); the MoE slots' load-balance losses come back summed as
``aux_loss``.
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
    emissions: tuple                # per slot its K/V or state, stacked over
    #                                 periods
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


def _self_attention_slot(slot, x, *, cfg: ModelConfig, mixer: str, ctx):
    """Returns (y, emission). An ``ATTN_LOCAL`` slot attends within
    ``cfg.sliding_window`` whatever ``use_long_window`` says."""
    h = L.apply_norm(slot["norm1"], x, cfg)
    q = L.project_q(slot["attn"], h, cfg)
    k, v = L.project_kv(slot["attn"], h, cfg)
    if cfg.pos_embed == "rope":
        q = L.rope(q, ctx["q_pos"], cfg.rope_theta)
        k = L.rope(k, ctx["q_pos"], cfg.rope_theta)
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
            slots = torch.arange(S, device=x.device)
            k_all = torch.cat([ck, k.to(ck.dtype)], dim=1)
            v_all = torch.cat([cv, v.to(cv.dtype)], dim=1)
            kv_pos = torch.cat([slots.expand(b, S), q_pos.expand(b, Lq)], 1)
            cache_ok = (slots[None, :] < ctx["cache_lens"][:, None]
                        if kernel_ok else ctx["cache_valid"].expand(b, S))
            kv_valid = torch.cat(
                [cache_ok,
                 torch.ones((b, Lq), dtype=torch.bool, device=x.device)], 1)
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
    return x + L.out_proj(slot["attn"], out, cfg), {"k": k, "v": v}


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


def _apply_slot(slot, x, *, cfg: ModelConfig, mixer: str, ffn: str, ctx,
                moe_per_row: bool):
    """One slot: its mixer (attention, Mamba or the RWKV time mix, each
    reading its own leaves of the cache slot, zeros without a cache), an
    encoder-decoder's cross attention, then its FFN (MLP, MOE or the RWKV
    channel mix, which reads the *input* state's ``cm_shift``). Returns
    (x, emission, the MOE FFN's aux loss or None)."""
    cache = ctx["cache_slot"]
    aux = rwkv_in = None
    if mixer in (ATTN, ATTN_LOCAL):
        x, em = _self_attention_slot(slot, x, cfg=cfg, mixer=mixer, ctx=ctx)
    elif mixer == MAMBA:
        state = (None if cache is None
                 else {"conv": cache["conv"], "ssm": cache["ssm"]})
        y, em = MB.mamba_forward(slot["mamba"],
                                 L.apply_norm(slot["norm1"], x, cfg), cfg,
                                 state=state)
        x = x + y
    else:   # RWKV
        rwkv_in = (R.init_rwkv_state(cfg, x.shape[0], dtype=x.dtype,
                                     device=x.device) if cache is None
                   else {"S": cache["S"], "tm_shift": cache["tm_shift"],
                         "cm_shift": cache["cm_shift"]})
        y, em = R.time_mix(slot["rwkv_tm"],
                           L.apply_norm(slot["norm1"], x, cfg), cfg, rwkv_in)
        x = x + y
    if "cross" in slot and (ctx["encoder_out"] is not None
                            or (cache is not None and "ck" in cache)):
        x, cross_em = _cross_attention_slot(slot, x, cfg=cfg, ctx=ctx)
        em.update(cross_em)
    h = L.apply_norm(slot["norm2"], x, cfg)
    if ffn == MOE:
        y, aux = MO.apply_moe(slot["moe"], h, cfg, dropless=cache is not None,
                              moe_per_row=moe_per_row)
    elif ffn == RWKV_CM:      # after an RWKV mixer, as in every config
        y, cm_em = R.channel_mix(slot["rwkv_cm"], h, cfg, rwkv_in)
        em.update(cm_em)
    else:
        y = L.apply_mlp(slot["mlp"], h, cfg)
    return x + y, em, aux


def _run_stack(slots_params, x, *, cfg: ModelConfig, slot_kinds, n: int,
               ctx, cache, remat: bool, moe_per_row: bool):
    """The ``n`` periods of ``slot_kinds`` over ``x``, each slot's params
    (and cache leaves) stacked over the periods. Returns (x, emissions
    stacked over periods per slot, the summed MoE aux loss)."""
    dev = x.device
    slots = [_by_period(slot_params, n) for slot_params in slots_params]
    cache_slots = (None if cache is None
                   else [_by_period(c, n) for c in cache])

    def period_body(x, aux, p: int):
        ems = []
        for i, (mixer, ffn) in enumerate(slot_kinds):
            c = dict(ctx, cache_slot=None if cache is None
                     else cache_slots[i][p])
            x, em, a = _apply_slot(slots[i][p], x, cfg=cfg, mixer=mixer,
                                   ffn=ffn, ctx=c, moe_per_row=moe_per_row)
            if a is not None:
                aux = aux + a
            ems.append(em)
        return x, aux, ems

    checkpointed = remat and torch.is_grad_enabled()
    emitted = [[] for _ in slot_kinds]
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    for p in range(n):
        if checkpointed:
            x, aux, ems = checkpoint(period_body, x, aux, p,
                                     use_reentrant=False)
        else:
            x, aux, ems = period_body(x, aux, p)
        for i, em in enumerate(ems):
            emitted[i].append(em)
    emissions = tuple({key: torch.stack([em[key] for em in ems])
                       for key in ems[0]} for ems in emitted)
    return x, emissions, aux


def encode(params, frames, *, cfg: ModelConfig, prefill_attention_fn=None,
           remat: bool = False) -> torch.Tensor:
    """Whisper's encoder over ``frames`` (b, enc_len, d), in their dtype:
    sinusoidal positions at ``arange(enc_len)``, ``cfg.n_encoder_layers``
    bidirectional ``(ATTN, MLP)`` layers without a cache (self attention
    through ``prefill_attention_fn`` where given), then the encoder's
    final norm. Returns the (b, enc_len, d) output every decoder layer's
    cross attention reads."""
    dev = frames.device
    enc_pos = torch.arange(frames.shape[1], device=dev)
    if cfg.pos_embed == "sinusoidal":
        frames = frames + L.sinusoidal_embedding(enc_pos, cfg.d_model).to(
            frames.dtype)
    ctx = dict(mode=masks.BIDIRECTIONAL, prompt_len=0, block_size=1,
               q_pos=enc_pos, cache_lens=None, cache_slot=None,
               cache_valid=None, pages=None, use_long_window=False,
               decode_attention_fn=None, paged_decode_attention_fn=None,
               prefill_attention_fn=prefill_attention_fn, encoder_out=None)
    x, _, _ = _run_stack(params["encoder"]["slots"], frames, cfg=cfg,
                         slot_kinds=((ATTN, MLP),), n=cfg.n_encoder_layers,
                         ctx=ctx, cache=None, remat=remat, moe_per_row=False)
    return L.apply_norm(params["encoder"]["final_norm"], x, cfg)


def forward(params, tokens, *, cfg: ModelConfig, device="cuda",
            mode: str = masks.BIDIRECTIONAL, prompt_len: int = 0,
            block_size: int = 1, positions=None, prefix_embeds=None,
            encoder_embeds=None, cache=None, cache_len=None,
            cache_valid=None, use_long_window: bool = False,
            decode_attention_fn=None, paged_decode_attention_fn=None,
            prefill_attention_fn=None, remat: bool = False,
            logits_slice: Optional[Tuple[int, int]] = None,
            return_logits: bool = True,
            moe_per_row: bool = False) -> ModelOutput:
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
    path) and for the encoder. ``return_logits=False`` skips the lm_head
    (the fused-select decode reads ``hidden``); ``logits_slice=(s0, s1)``
    applies it to positions ``[s0, s1)`` only (the CDLM losses read
    generation-span logits). ``remat`` recomputes each layer period in
    the backward (``torch.utils.checkpoint``, as the JAX package's
    ``jax.checkpoint`` of the period body) when grad mode is on. The MoE
    slots of a cached forward size their expert buffers by the decode's
    bounded capacity (dropless), those of a cache-less one by the
    capacity factor, as the reference's defaults do. ``moe_per_row``
    gives each row of the batch its own expert capacity (as in
    ``models.moe.apply_moe``): the reference's per-lane forward.
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
            cfg=cfg, prefill_attention_fn=encoder_attention_fn, remat=remat)

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
               encoder_out=encoder_out)
    x, emissions, aux = _run_stack(params["slots"], x, cfg=cfg,
                                   slot_kinds=cfg.layer_period,
                                   n=cfg.n_periods, ctx=ctx, cache=cache,
                                   remat=remat, moe_per_row=moe_per_row)

    hidden = L.apply_norm(params["final_norm"], x, cfg)
    if not return_logits:
        return ModelOutput(logits=None, hidden=hidden, emissions=emissions,
                           aux_loss=aux)
    head_in = (hidden if logits_slice is None
               else hidden[:, logits_slice[0]:logits_slice[1]])
    return ModelOutput(logits=L.lm_head(params["embed"], head_in, cfg),
                       hidden=hidden, emissions=emissions, aux_loss=aux)
