"""Training CLI of the port, the JAX package's ``launch/train.py`` stages
and flags plus ``--device``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --stage teacher --steps 500 [--reduced]
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --stage cdlm --steps 2 --student-steps 2 --batch-size 8

Stages: ``teacher`` (Eq. 6 DLM SFT), ``ar`` (AR baseline), ``cdlm`` (the
full teacher -> trajectories (τ = 0) -> student pipeline). As in the JAX
CLI, the configs are always the ``reduced()`` variants in fp32, the data
is the synthetic task, an ``ssm`` config (rwkv6, no bidirectional teacher)
trains ``ar`` whatever the stage, and the ``cdlm`` stage's teacher of a
``hybrid`` config (jamba) trains block-causally. Without ``--device cpu``
it raises when there is no CUDA device.
"""
import argparse
import dataclasses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--stage", default="cdlm",
                    choices=["teacher", "ar", "cdlm"])
    ap.add_argument("--task", default="sort", choices=["sort", "add"])
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--student-steps", type=int, default=300)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--block-size", type=int, default=5)
    ap.add_argument("--lora", action="store_true")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch import resolve_device
    from repro_torch.checkpoint import save
    from repro_torch.configs import CDLMConfig, TrainConfig, get_config
    from repro_torch.core import masks
    from repro_torch.data import Corpus, TaskSpec
    from repro_torch.training import trainer

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(dtype="float32")
    task = TaskSpec(args.task, vocab_size=cfg.vocab_size, prompt_len=15,
                    gen_len=10, sort_k=8, sort_range=24, add_digits=4)
    corpus = Corpus(task, 768, seed=0)
    tcfg = TrainConfig(learning_rate=args.lr, steps=args.steps,
                       batch_size=args.batch_size, remat=False,
                       use_lora=args.lora)

    if args.stage == "ar" or cfg.family == "ssm":
        params = trainer.train_ar(cfg, corpus, tcfg, device=dev)
    elif args.stage == "teacher":
        params = trainer.train_teacher(cfg, corpus, tcfg, device=dev)
    else:
        cdlm_cfg = CDLMConfig(block_size=args.block_size, gen_length=10,
                              prompt_length=15, temperatures=(0.0,))
        mode = (masks.BLOCK_CAUSAL if cfg.family == "hybrid"
                 else masks.BIDIRECTIONAL)
        teacher = trainer.train_teacher(cfg, corpus, tcfg, mode=mode,
                                        block_size=args.block_size,
                                        device=dev)
        ds = trainer.collect_dataset(teacher, cfg, cdlm_cfg, corpus,
                                     n_examples=128, batch=args.batch_size)
        scfg = dataclasses.replace(tcfg, steps=args.student_steps,
                                   learning_rate=5e-4)
        params = trainer.train_student(teacher, ds, cfg, cdlm_cfg, scfg)

    if args.ckpt:
        save(params, args.ckpt)
        print(f"saved -> {args.ckpt}")


if __name__ == "__main__":
    main()
