"""Training loops, ported from the JAX package's
``training/trainer.py``: teacher SFT -> trajectory collection (Alg. 1, at
every temperature of ``CDLMConfig.temperatures``) -> CDLM student
distillation (Alg. 2), full fine-tune or LoRA.

Every loop runs on the CUDA device unless given ``device="cpu"``; the
collected dataset lives as tensors on that device. Randomness comes from
``torch.Generator``s seeded like the JAX loops' keys (other numbers from
the same seed), apart from collection, which draws from the reference's
own stream, ``PRNGKey(seed)`` split once per batch. ``history``, where
given, receives each step's metrics (``train_teacher``,
``train_student``).
"""
from __future__ import annotations

import time

import torch

from repro_torch import prng, resolve_device
from repro_torch import tree as T
from repro_torch.bridge import init_params
from repro_torch.configs.base import CDLMConfig, ModelConfig, TrainConfig
from repro_torch.core import masks, trajectory
from repro_torch.data import Corpus, answer_mask
from repro_torch.models import lora as LoRA
from repro_torch.optim import adamw
from repro_torch.training import steps as S


def _log(step, metrics, every=50, t0=None):
    if step % every == 0:
        ms = {k: float(v) for k, v in metrics.items()}
        extra = f" ({time.time() - t0:.0f}s)" if t0 else ""
        print(f"  step {step:5d}  " +
              "  ".join(f"{k}={v:.4f}" for k, v in sorted(ms.items()))
              + extra)


def _batch(b, dev):
    return {"prompt": torch.as_tensor(b["prompt"], dtype=torch.int64,
                                      device=dev),
            "answer": torch.as_tensor(b["answer"], dtype=torch.int64,
                                      device=dev),
            "maskable": torch.as_tensor(answer_mask(b["answer"]),
                                        device=dev)}


def _record(history, metrics):
    if history is not None:
        history.append(metrics)


def train_teacher(cfg: ModelConfig, corpus: Corpus, tcfg: TrainConfig, *,
                  mode: str = masks.BIDIRECTIONAL, block_size: int = 1,
                  seed: int = 0, verbose: bool = True, device="cuda",
                  history=None):
    """Masked-denoising SFT of the teacher DLM from a seeded random init."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_params(cfg, gen, dev)
    opt = adamw.init(params)
    step_fn = S.make_dlm_pretrain_step(cfg, tcfg, mode=mode,
                                       block_size=block_size)
    t0 = time.time()
    it = corpus.batches(tcfg.batch_size, seed=seed, epochs=10_000)
    for i in range(tcfg.steps):
        batch = _batch(next(it), dev)
        b, G = batch["answer"].shape
        params, opt, metrics = step_fn(params, opt, batch,
                                       S.dlm_draws(gen, b, G, dev))
        _record(history, metrics)
        if verbose:
            _log(i, metrics, t0=t0)
    return params


def train_ar(cfg: ModelConfig, corpus: Corpus, tcfg: TrainConfig, *,
             seed: int = 0, verbose: bool = True, device="cuda"):
    dev = resolve_device(device)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                         dev)
    opt = adamw.init(params)
    step_fn = S.make_ar_step(cfg, tcfg)
    t0 = time.time()
    it = corpus.batches(tcfg.batch_size, seed=seed, epochs=10_000)
    for i in range(tcfg.steps):
        params, opt, metrics = step_fn(params, opt, _batch(next(it), dev))
        if verbose:
            _log(i, metrics, t0=t0)
    return params


def collect_dataset(teacher_params, cfg: ModelConfig, cdlm: CDLMConfig,
                    corpus: Corpus, *, n_examples: int, batch: int = 16,
                    seed: int = 0, extras=None, verbose: bool = True):
    """Alg. 1 over the corpus, batch by batch, through the block attention
    and fused select kernels (``trajectory.collect``, each batch with the
    request ``extras``, (batch, ...) each, as the reference passes them),
    with ``PRNGKey(seed)`` split once per batch as the reference does; the
    dataset's tensors stay on the params' device."""
    dev = teacher_params["embed"]["tok"].device
    key = prng.key(seed, dev)
    chunks = []
    done = 0
    for b in corpus.batches(batch, seed=seed, epochs=100):
        if done >= n_examples:
            break
        tb = _batch(b, dev)
        key, sub = prng.split(key)
        chunks.append(trajectory.collect(
            teacher_params, tb["prompt"], tb["answer"], cfg=cfg, cdlm=cdlm,
            key=sub, extras=extras, fused_select=True))
        done += batch
        if verbose and done % (batch * 4) == 0:
            print(f"  collected {done}/{n_examples} prompts "
                  f"(x{len(cdlm.temperatures)} temps)")
    return {k: torch.cat([c[k] for c in chunks], dim=0) for k in chunks[0]}


def train_student(teacher_params, dataset, cfg: ModelConfig,
                  cdlm: CDLMConfig, tcfg: TrainConfig, *, seed: int = 0,
                  student_mode: str = masks.BLOCK_CAUSAL,
                  efficient_loss: bool = False, verbose: bool = True,
                  history=None):
    """Alg. 2 on the params' device. The student starts from the teacher's
    weights (paper §4.1), optionally as LoRA adapters over them; returns
    the (merged) student params."""
    dev = teacher_params["embed"]["tok"].device
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    teacher_head = T.tree_map(torch.clone, teacher_params["embed"])
    if tcfg.use_lora:
        trainable = LoRA.init_lora(gen, teacher_params, rank=tcfg.lora_rank)
        static = teacher_params
    else:
        trainable = T.tree_map(torch.clone, teacher_params)
        static = None
    opt = adamw.init(trainable)
    step_fn = S.make_cdlm_step(cfg, cdlm, tcfg, student_mode=student_mode,
                               efficient_loss=efficient_loss)
    t0 = time.time()
    for i in range(tcfg.steps):
        batch = trajectory.sample_training_pair(dataset, gen, tcfg.batch_size,
                                                cfg=cfg, cdlm=cdlm)
        draws = S.dlm_draws(gen, tcfg.batch_size, cdlm.gen_length, dev)
        trainable, opt, metrics = step_fn(trainable, opt, static,
                                          teacher_head, batch, draws)
        _record(history, metrics)
        if verbose:
            _log(i, metrics, t0=t0)
    if tcfg.use_lora:
        with torch.no_grad():
            return LoRA.merge(static, trainable, tcfg.lora_alpha,
                              tcfg.lora_rank)
    return trainable
