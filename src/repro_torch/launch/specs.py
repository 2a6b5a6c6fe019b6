"""Per (arch x input shape) step functions and their meta-device inputs for
the dry-run, the counterpart of the JAX package's ``launch/specs.py``.

Shapes (``configs.base.INPUT_SHAPES``):
- train_4k: the CDLM three-objective train step (the AR step for rwkv6),
  batch 256 x seq 4096 (prompt 2048 + generation 2048);
- prefill_32k: the block-causal prompt prefill emitting the exact cache;
- decode_32k: one refinement step of the active 32-token block against a
  32k cache (a one-token step for rwkv6), batch 128;
- long_500k: the same against a 524,288-token cache, batch 1, on
  sub-quadratic paths only (the state of an SSM, a sliding window, the
  long-window decode, a sequence-sharded cache); whisper-base skipped.

Every parameter, cache row and input is a meta tensor: nothing is
allocated or drawn. A step is built with the forward's kernel hooks left
``None`` (the generic attention) and a plain cross-entropy passed to the
losses: the kernels' wrappers take CPU or CUDA tensors only. Each plan
carries the specs of its inputs (``parallel/sharding.py``) and the
collectives they imply (``roofline/collectives.py``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import tree as T
from repro_torch.bridge import _leaf_dtype, _map, _specs, torch_dtype
from repro_torch.configs.base import (
    INPUT_SHAPES,
    MOE,
    CDLMConfig,
    ModelConfig,
    TrainConfig,
)
from repro_torch.configs.registry import get_config
from repro_torch.core import masks
from repro_torch.core.cache import init_cache
from repro_torch.kernels.xent.ref import xent_ref
from repro_torch.models import forward
from repro_torch.optim import adamw
from repro_torch.parallel import sharding as SH
from repro_torch.parallel.seq_decode import make_sharded_decode_attention
from repro_torch.roofline import collectives as C
from repro_torch.training import steps as ST

META = torch.device("meta")
BLOCK = 32  # the paper's B


class SkipPair(Exception):
    """(arch, shape) combination intentionally skipped; reason in args."""


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device=META)


def abstract_params(cfg: ModelConfig):
    """Meta leaves of the shapes and dtypes ``bridge.init_params`` would
    allocate."""
    dt = torch_dtype(cfg.dtype)
    return _map(lambda spec: _meta(spec[0], _leaf_dtype(spec, dt)),
                _specs(cfg))


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int):
    return init_cache(cfg, batch, max_len, dtype=cfg.dtype, device=META)


def _rows_spec(b_ax, ndim: int, batch_dim: int = 0) -> tuple:
    spec = [None] * ndim
    spec[batch_dim] = b_ax
    return tuple(spec)


@dataclasses.dataclass
class DryRunPlan:
    fn: Callable                 # the step, called on ``args``
    args: Tuple[Any, ...]        # meta tensor trees
    in_specs: Tuple[Any, ...]    # a spec tree per arg (tuple leaves)
    out_specs: Callable          # outputs -> a spec tree mirroring them
    meta: Dict[str, Any]
    collectives: List[C.Op]      # per-chip (kind, bytes, shape, axes)
    batch_shards: int            # chips a batch row is split over
    grad: bool                   # the step runs a backward
    mesh: Any = None             # the mesh the specs are of


def _extras(cfg: ModelConfig, b: int, b_ax):
    extras, especs = {}, {}
    dt = torch_dtype(cfg.dtype)
    if cfg.is_encoder_decoder:
        extras["encoder_embeds"] = _meta((b, cfg.encoder_seq_len,
                                          cfg.d_model), dt)
        especs["encoder_embeds"] = (b_ax, None, None)
    if cfg.n_prefix_embeds:
        extras["prefix_embeds"] = _meta((b, cfg.n_prefix_embeds,
                                         cfg.d_model), dt)
        especs["prefix_embeds"] = (b_ax, None, None)
    return extras, especs


def _train_plan(cfg: ModelConfig, mesh, shape, *, fsdp: bool = True,
                efficient_loss: bool = False):
    b, Lseq = shape.global_batch, shape.seq_len
    Pl = Lseq // 2
    G = Lseq - Pl
    cdlm = CDLMConfig(block_size=BLOCK, gen_length=G, prompt_length=Pl)
    tcfg = TrainConfig(remat=True)
    b_ax = SH.batch_axes(mesh, b)
    shards = SH.axis_size(mesh, b_ax)
    params = abstract_params(cfg)
    pspecs = SH.param_specs(params, mesh, fsdp=fsdp)
    opt = adamw.init(params)
    ospecs = ((), pspecs, pspecs)          # AdamWState(step, m, v)
    tok = lambda *s: _meta(s, torch.int64)
    boo = lambda *s: _meta(s, torch.bool)
    xent = functools.partial(xent_ref, softcap=cfg.final_logit_softcap)
    dt = torch_dtype(cfg.dtype)
    rows = b // shards
    enc = cfg.encoder_seq_len if cfg.is_encoder_decoder else 0

    def out_specs(out):
        return (pspecs, ospecs, ())

    if cfg.family == "ssm":
        # CDLM is inapplicable to an attention-free backbone: the AR
        # next-token training step
        batch = {"prompt": tok(b, Pl), "answer": tok(b, G),
                 "maskable": boo(b, G)}
        bspecs = {k: (b_ax, None) for k in batch}

        def fn(params, opt_state, batch):
            (loss, _), grads = ST.value_and_grad(
                lambda p: ST.ar_loss(p, batch, cfg=cfg, remat=True,
                                     xent_fn=xent), params)
            params, opt_state, _ = adamw.update(grads, opt_state, params,
                                                tcfg)
            return params, opt_state, loss

        # one forward, its remat recompute and one backward
        ops = C.param_ops(params, mesh, fsdp=fsdp, gathers=2, grads=True,
                          batch_axes=b_ax)
        ops += C.activation_ops(params, mesh, cfg, rows=rows,
                                seq_len=Lseq - 1, passes=3, dtype=dt)
        return DryRunPlan(
            fn=fn, args=(params, opt, batch),
            in_specs=(pspecs, ospecs, bspecs), out_specs=out_specs,
            meta={"kind": "train_ar", "tokens": b * Lseq,
                  "gen_tokens": b * G},
            collectives=ops, batch_shards=shards, grad=True, mesh=mesh)

    extras, especs = _extras(cfg, b, b_ax)
    batch = {"y": tok(b, Lseq), "y_star": tok(b, Lseq),
             "u_mask": boo(b, Lseq), "s_mask": boo(b, Lseq),
             "teacher_hidden": _meta((b, G, cfg.d_model), dt),
             "gt": tok(b, G), "prompt": tok(b, Pl)}
    bspecs = {k: _rows_spec(b_ax, v.ndim) for k, v in batch.items()}
    batch.update(extras)
    bspecs.update(especs)
    draws = {"t": _meta((b,), torch.float32),
             "u": _meta((b, G), torch.float32)}
    dspecs = {"t": (b_ax,), "u": (b_ax, None)}
    teacher_head = {k: torch.empty_like(v) for k, v in
                    params["embed"].items()}
    thspecs = SH.param_specs({"embed": teacher_head}, mesh,
                             fsdp=fsdp)["embed"]

    def fn(params, opt_state, batch, draws, teacher_head):
        extras_in = {k: batch[k] for k in ("encoder_embeds", "prefix_embeds")
                     if k in batch}
        core = {k: v for k, v in batch.items() if k not in extras_in}
        (loss, _), grads = ST.value_and_grad(
            lambda p: ST.cdlm_loss(
                p, None, core, draws, cfg=cfg, cdlm=cdlm,
                teacher_head=teacher_head, use_lora=False, remat=True,
                student_mode=masks.BLOCK_CAUSAL, extras=extras_in,
                efficient_loss=efficient_loss, xent_fn=xent), params)
        params, opt_state, _ = adamw.update(grads, opt_state, params, tcfg)
        return params, opt_state, loss

    # three forwards (y, y*, the DLM canvas); y*'s keeps its graph only
    # with MoE slots (its router's aux loss). Each backward first reruns
    # its forward (remat).
    backwards = 2 + int(any(f == MOE for _, f in cfg.layer_period))
    ops = C.param_ops(params, mesh, fsdp=fsdp, gathers=3 + backwards,
                      grads=True, batch_axes=b_ax)
    ops += C.activation_ops(params, mesh, cfg, rows=rows,
                            seq_len=Lseq + cfg.n_prefix_embeds,
                            passes=3 + 2 * backwards, dtype=dt, enc_len=enc)
    return DryRunPlan(
        fn=fn, args=(params, opt, batch, draws, teacher_head),
        in_specs=(pspecs, ospecs, bspecs, dspecs, thspecs),
        out_specs=out_specs,
        meta={"kind": "train_cdlm", "tokens": b * Lseq,
              "gen_tokens": b * G},
        collectives=ops, batch_shards=shards, grad=True, mesh=mesh)


def _emission_specs(out, b_ax, batch_dim):
    """Outputs' specs: the batch dim of every leaf over the batch axes."""
    def spec(t):
        return _rows_spec(b_ax, t.ndim, batch_dim)
    return tuple({k: spec(v) for k, v in slot.items()} for slot in out)


def _prefill_plan(cfg: ModelConfig, mesh, shape, *, fsdp: bool = True):
    b, Lseq = shape.global_batch, shape.seq_len
    b_ax = SH.batch_axes(mesh, b)
    shards = SH.axis_size(mesh, b_ax)
    params = abstract_params(cfg)
    pspecs = SH.param_specs(params, mesh, fsdp=fsdp)
    tokens = _meta((b, Lseq), torch.int64)
    extras, especs = _extras(cfg, b, b_ax)
    mode = masks.CAUSAL if cfg.family == "ssm" else masks.BLOCK_CAUSAL
    n = Lseq + cfg.n_prefix_embeds

    def fn(params, tokens, extras):
        out = forward(params, tokens, cfg=cfg, device=META, mode=mode,
                      prompt_len=n, block_size=BLOCK, remat=True,
                      logits_slice=(n - 1, n), **extras)
        # the last position's logits and the cache emissions (committed by
        # the serving layer): what a server materializes
        return out.logits[:, -1], out.emissions

    def out_specs(out):
        return ((b_ax, None), _emission_specs(out[1], b_ax, 1))

    enc = cfg.encoder_seq_len if cfg.is_encoder_decoder else 0
    ops = C.param_ops(params, mesh, fsdp=fsdp, gathers=1, grads=False,
                      batch_axes=b_ax)
    ops += C.activation_ops(params, mesh, cfg, rows=b // shards, seq_len=n,
                            passes=1, dtype=torch_dtype(cfg.dtype),
                            enc_len=enc)
    return DryRunPlan(
        fn=fn, args=(params, tokens, extras),
        in_specs=(pspecs, (b_ax, None), especs), out_specs=out_specs,
        meta={"kind": "prefill", "tokens": b * Lseq, "gen_tokens": 0},
        collectives=ops, batch_shards=shards, grad=False, mesh=mesh)


def _heads_sharded(params, mesh, leaf: str) -> bool:
    """Whether the decoder's self-attention ``leaf`` (``wq``, ``wk``)
    has its head dim sharded over ``model``."""
    for path, w in T.leaves_with_path(params):
        name = T.key_path(path)
        if name.endswith("attn/" + leaf) and not name.startswith("encoder/"):
            return "model" in SH.spec_axes(SH.leaf_spec(path, w, mesh)[-1:])
    return False


def _decode_plan(cfg: ModelConfig, mesh, shape, *, fsdp: bool = True,
                 seq_parallel_decode: bool = False):
    b, S = shape.global_batch, shape.seq_len
    long = shape.name == "long_500k"
    if long and cfg.name == "whisper-base":
        raise SkipPair(
            "whisper-base × long_500k: 30 s/1500-frame encoder with a ~448-"
            "token decoder has no meaningful 524k-token decode state "
            "(DESIGN.md §6)")
    if long:
        sub_quadratic = (cfg.is_attention_free or cfg.family in ("hybrid",)
                         or cfg.sliding_window is not None
                         or cfg.long_context_window is not None)
        if not sub_quadratic:
            raise SkipPair(f"{cfg.name} × long_500k: no sub-quadratic path")

    Bq = 1 if cfg.family == "ssm" else BLOCK
    b_ax = SH.batch_axes(mesh, b)
    shards = SH.axis_size(mesh, b_ax)
    params = abstract_params(cfg)
    pspecs = SH.param_specs(params, mesh, fsdp=fsdp)
    # attention-free archs carry O(1) state, no (b, S, kv, hd) buffers
    cache = abstract_cache(cfg, b, 0 if cfg.is_attention_free else S)
    # long-context always seq-shards the cache; decode_32k only under the
    # --seq-parallel-decode variant
    seq_shard = (long or seq_parallel_decode) and not cfg.is_attention_free
    cspecs = SH.cache_specs(cache, mesh, cfg, b, seq_shard=seq_shard)
    tokens = _meta((b, Bq), torch.int64)
    clen = _meta((), torch.int32)
    use_long_window = bool(long and cfg.long_context_window)
    mode = masks.CAUSAL if cfg.family == "ssm" else masks.BLOCK_CAUSAL
    # the dry-run counts the whole step on one "rank": the sequence-
    # parallel decode's arithmetic, its merges listed as collectives
    dec_fn = (make_sharded_decode_attention(axis_size=1, axis_rank=0)
              if seq_parallel_decode and seq_shard else None)

    def fn(params, tokens, cache, cache_len):
        out = forward(params, tokens, cfg=cfg, device=META, mode=mode,
                      prompt_len=0, block_size=Bq, cache=cache,
                      cache_len=cache_len, use_long_window=use_long_window,
                      decode_attention_fn=dec_fn)
        return out.logits, out.emissions

    def out_specs(out):
        return ((b_ax, None, None), _emission_specs(out[1], b_ax, 1))

    dt = torch_dtype(cfg.dtype)
    ops = C.param_ops(params, mesh, fsdp=fsdp, gathers=1, grads=False,
                      batch_axes=b_ax)
    ops += C.activation_ops(params, mesh, cfg, rows=b // shards, seq_len=Bq,
                            passes=1, dtype=dt)
    if seq_shard:
        ops += C.decode_ops(cfg, rows=b // shards, Bq=Bq, S=S, dtype=dt,
                            seq_parallel=seq_parallel_decode,
                            q_sharded=_heads_sharded(params, mesh, "wq"),
                            kv_sharded=_heads_sharded(params, mesh, "wk"))
    return DryRunPlan(
        fn=fn, args=(params, tokens, cache, clen),
        in_specs=(pspecs, (b_ax, None), cspecs, ()), out_specs=out_specs,
        meta={"kind": "decode", "tokens": b * Bq, "gen_tokens": b * Bq,
              "cache_len": S, "seq_shard": seq_shard},
        collectives=ops, batch_shards=shards, grad=False, mesh=mesh)


def build_plan(arch: str, shape_name: str, mesh, *, fsdp: bool = True,
               seq_parallel_decode: bool = False,
               roofline_periods: Optional[int] = None,
               efficient_loss: bool = False) -> DryRunPlan:
    """The step of ``arch`` at ``shape_name`` on ``mesh``.
    ``roofline_periods=k`` builds a depth-k variant (k periods, and k
    encoder layers for an encoder-decoder), the dry-run's check of its
    full-depth count against the linear extrapolation from depth 1 and 2."""
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    if roofline_periods is not None:
        k = roofline_periods
        cfg = dataclasses.replace(
            cfg, n_layers=k * len(cfg.layer_period),
            n_encoder_layers=(k if cfg.is_encoder_decoder else 0))
    if shape.kind == "train":
        return _train_plan(cfg, mesh, shape, fsdp=fsdp,
                           efficient_loss=efficient_loss)
    if shape.kind == "prefill":
        return _prefill_plan(cfg, mesh, shape, fsdp=fsdp)
    return _decode_plan(cfg, mesh, shape, fsdp=fsdp,
                        seq_parallel_decode=seq_parallel_decode)
