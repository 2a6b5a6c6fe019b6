"""Quickstart on the PyTorch port: the whole CDLM pipeline on the toy
sort task, the counterpart of ``examples/quickstart.py``.

1. pretrain a tiny bidirectional teacher DLM on the synthetic sort task;
2. collect Alg.-1 teacher trajectories (+ hidden-state buffer);
3. distill the block-causal CDLM student with the 3-objective loss;
4. compare vanilla teacher decoding vs CDLM student decoding.

    python examples/quickstart_torch.py                 # on the GPU
    python examples/quickstart_torch.py --device cpu --teacher-steps 2 \
        --student-steps 2 --examples 16 --eval 8        # seconds on a CPU
"""
import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch import resolve_device
from repro_torch.configs import CDLMConfig, TrainConfig, get_config
from repro_torch.core.sampler import SamplerSpec, cdlm, vanilla_blockwise
from repro_torch.data import Corpus, TaskSpec, score
from repro_torch.training import trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--teacher-steps", type=int, default=600)
    ap.add_argument("--student-steps", type=int, default=250)
    ap.add_argument("--examples", type=int, default=128,
                    help="prompts whose trajectories are collected")
    ap.add_argument("--eval", type=int, default=64, help="eval prompts")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    t0 = time.time()
    cfg = get_config("qwen2-0.5b").reduced(
        n_layers=2, d_model=128, d_ff=256, vocab_size=128, mask_token_id=127)
    task = TaskSpec("sort", vocab_size=128, prompt_len=10, gen_len=10,
                    sort_k=8, sort_range=24)
    cdlm_cfg = CDLMConfig(block_size=5, gen_length=10, prompt_length=10,
                          temperatures=(0.0,))
    corpus = Corpus(task, 768, seed=0)
    batch = min(64, args.examples)

    print("[1/4] pretraining bidirectional teacher (Eq. 6)...")
    tcfg = TrainConfig(learning_rate=2e-3, steps=args.teacher_steps,
                       batch_size=64, remat=False)
    teacher = trainer.train_teacher(cfg, corpus, tcfg, verbose=False,
                                    device=dev)

    print("[2/4] collecting teacher trajectories (Alg. 1)... "
          f"({time.time()-t0:.0f}s)")
    ds = trainer.collect_dataset(teacher, cfg, cdlm_cfg, corpus,
                                 n_examples=args.examples, batch=batch,
                                 verbose=False)

    print("[3/4] distilling block-causal CDLM student (Alg. 2)... "
          f"({time.time()-t0:.0f}s)")
    scfg = dataclasses.replace(tcfg, steps=args.student_steps,
                               learning_rate=5e-4)
    student = trainer.train_student(teacher, ds, cfg, cdlm_cfg, scfg,
                                    verbose=False)

    print(f"[4/4] evaluating... ({time.time()-t0:.0f}s)")
    ev = corpus.eval_batch(args.eval)
    prompts = torch.as_tensor(ev["prompt"], device=dev)
    spec = SamplerSpec(prompt_len=10, gen_len=10, block_size=5,
                       conf_threshold=0.9)
    rt = vanilla_blockwise(teacher, prompts, cfg=cfg, spec=spec)
    rs = cdlm(student, prompts, cfg=cfg, spec=spec)
    st = score(ev["prompt"], rt.tokens.cpu().numpy(), 10, task)
    ss = score(ev["prompt"], rs.tokens.cpu().numpy(), 10, task)
    t_steps = float(rt.steps.float().mean())
    s_steps = float(rs.steps.float().mean())
    print(f"\nteacher (vanilla, no cache): score={st:.2f} "
          f"steps={t_steps:.1f}")
    print(f"student (CDLM, KV cache):    score={ss:.2f} "
          f"steps={s_steps:.1f}  "
          f"<- {t_steps / max(s_steps, 1e-9):.1f}x fewer steps")
    print(f"done in {time.time()-t0:.0f}s")
    return {"teacher_score": st, "student_score": ss,
            "teacher_steps": t_steps, "student_steps": s_steps,
            "teacher_gen_length": float(rt.gen_lengths.float().mean()),
            "student_gen_length": float(rs.gen_lengths.float().mean())}


if __name__ == "__main__":
    main()
