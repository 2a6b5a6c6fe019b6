"""Configurable end-to-end CDLM training on the PyTorch port, the
counterpart of ``examples/train_cdlm.py``.

Runs the full paper pipeline (teacher Eq.-6 SFT -> Alg.-1 trajectory
collection -> Alg.-2 consistency distillation, optionally LoRA) on any
architecture's REDUCED variant and either synthetic task.

    python examples/train_cdlm_torch.py --arch qwen2-0.5b --task add \
        --teacher-steps 800 --student-steps 300 --lora
    python examples/train_cdlm_torch.py --device cpu --teacher-steps 2 \
        --student-steps 2 --examples 16 --eval 8    # seconds on a CPU
"""
import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import save
from repro_torch.configs import (
    ARCHITECTURES,
    CDLMConfig,
    TrainConfig,
    get_config,
)
from repro_torch.core import masks
from repro_torch.core.sampler import SamplerSpec, cdlm, vanilla_blockwise
from repro_torch.data import Corpus, TaskSpec, score
from repro_torch.training import trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b",
                    choices=sorted(ARCHITECTURES))
    ap.add_argument("--task", default="sort", choices=["sort", "add"])
    ap.add_argument("--teacher-steps", type=int, default=700)
    ap.add_argument("--student-steps", type=int, default=300)
    ap.add_argument("--block-size", type=int, default=5)
    ap.add_argument("--examples", type=int, default=128,
                    help="prompts whose trajectories are collected")
    ap.add_argument("--eval", type=int, default=32, help="eval prompts")
    ap.add_argument("--lora", action="store_true")
    ap.add_argument("--save", default=None, help="checkpoint prefix")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch).reduced(dtype="float32")
    if cfg.family == "ssm":
        print(f"{args.arch} is attention-free: CDLM is inapplicable; "
              "training the AR path instead.")
    task = TaskSpec(args.task, vocab_size=cfg.vocab_size, prompt_len=15,
                    gen_len=10, sort_k=8, sort_range=24, add_digits=4)
    cdlm_cfg = CDLMConfig(block_size=args.block_size, gen_length=10,
                          prompt_length=15, temperatures=(0.0,))
    corpus = Corpus(task, 768, seed=0)
    tcfg = TrainConfig(learning_rate=2e-3, steps=args.teacher_steps,
                       batch_size=32, remat=False, use_lora=args.lora)

    if cfg.family == "ssm":
        model = trainer.train_ar(cfg, corpus, tcfg, device=dev)
        if args.save:
            save(model, args.save + "_ar.npz")
        return {}

    # hybrid backbones (jamba) train the student-only block-diffusion form
    teacher_mode = (masks.BLOCK_CAUSAL if cfg.family == "hybrid"
                    else masks.BIDIRECTIONAL)
    print(f"== teacher ({teacher_mode}) ==")
    teacher = trainer.train_teacher(cfg, corpus, tcfg, mode=teacher_mode,
                                    block_size=args.block_size, device=dev)
    print("== trajectories (Alg. 1) ==")
    ds = trainer.collect_dataset(teacher, cfg, cdlm_cfg, corpus,
                                 n_examples=args.examples,
                                 batch=min(32, args.examples))
    print(f"== student (Alg. 2{' + LoRA' if args.lora else ''}) ==")
    scfg = dataclasses.replace(tcfg, steps=args.student_steps,
                               learning_rate=5e-4)
    student = trainer.train_student(teacher, ds, cfg, cdlm_cfg, scfg)

    ev = corpus.eval_batch(args.eval)
    prompts = torch.as_tensor(ev["prompt"], device=dev)
    spec = SamplerSpec(prompt_len=15, gen_len=10, block_size=args.block_size,
                       conf_threshold=0.9)
    rt = vanilla_blockwise(teacher, prompts, cfg=cfg, spec=spec)
    rs = cdlm(student, prompts, cfg=cfg, spec=spec)
    out = {"teacher_score": score(ev["prompt"], rt.tokens.cpu().numpy(), 15,
                                  task),
           "student_score": score(ev["prompt"], rs.tokens.cpu().numpy(), 15,
                                  task),
           "teacher_steps": float(rt.steps.float().mean()),
           "student_steps": float(rs.steps.float().mean()),
           "teacher_gen_length": float(rt.gen_lengths.float().mean()),
           "student_gen_length": float(rs.gen_lengths.float().mean())}
    print(f"teacher: score={out['teacher_score']:.2f} "
          f"steps={out['teacher_steps']:.1f}")
    print(f"student: score={out['student_score']:.2f} "
          f"steps={out['student_steps']:.1f}")
    if args.save:
        save(teacher, args.save + "_teacher.npz")
        save(student, args.save + "_student.npz")
        print(f"saved to {args.save}_{{teacher,student}}.npz")
    return out


if __name__ == "__main__":
    main()
