"""Trajectory collection for CDLM training (paper Alg. 1, App. A.1),
ported from the JAX package's ``core/trajectory.py``.

The teacher decodes block-wise with N = G steps, finalizing exactly one
top-confidence token per step. Because unmasking is monotone, the whole
trajectory is stored losslessly as ``(final_tokens, finalized_at)``: the
state at step s re-masks every position finalized at step >= s. The
hidden buffer H (G, d) holds the teacher's last hidden state at each
position's finalization (the paper's ~30x cheaper alternative to storing
V-dim logits). Each temperature of the augmentation set decodes with its
own key, split from the batch's as the reference splits it; a sampled
temperature draws from the reference's streams.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch import prng
from repro_torch.configs.base import CDLMConfig, ModelConfig
from repro_torch.core.sampler import SamplerSpec, vanilla_blockwise


def state_at(final_tokens, finalized_at, step, mask_id: int):
    """Trajectory state y_{t_step} from the compact encoding.

    final_tokens/finalized_at: (..., G); step: scalar or (...,) int."""
    step = torch.as_tensor(step, device=finalized_at.device)
    while step.ndim < final_tokens.ndim:
        step = step[..., None]
    revealed = (finalized_at >= 0) & (finalized_at < step)
    return torch.where(revealed, final_tokens,
                       torch.full_like(final_tokens, mask_id))


def block_completion_step(t_start, block_size: int):
    """t_end: the step at which t_start's active block completes (at most B
    steps later; strictly greater than t_start)."""
    return (t_start // block_size + 1) * block_size


def position_sets(finalized_at, t_start, t_end):
    """U_y (newly unmasked between y and y*) and S_y (still masked at y*)."""
    t_start = torch.as_tensor(t_start, device=finalized_at.device)[..., None]
    t_end = torch.as_tensor(t_end, device=finalized_at.device)[..., None]
    u = (finalized_at >= t_start) & (finalized_at < t_end)
    s = finalized_at >= t_end
    return u, s


def collect(params, prompts, gt_answers, *, cfg: ModelConfig,
            cdlm: CDLMConfig, key=None, extras=None,
            fused_select: bool = False,
            graphs=None) -> Dict[str, torch.Tensor]:
    """Alg. 1 over one batch of prompts for every temperature of
    ``cdlm.temperatures``. Returns tensors stacked over temperatures.

    prompts: (b, P) int; gt_answers: (b, G) int; ``extras``: the request
    extras of the batch (whisper's frames; a prefix is refused, since the
    reference's collector decodes it without a ``pos_offset``). ``key``
    (default
    ``PRNGKey(0)``) is split once per temperature, the second half that
    temperature's stream. ``fused_select`` is ``SamplerSpec.fused_select``
    (default False, as in the JAX package): True runs the forwards through
    the block attention kernel (a CUDA graph, ``graphs`` as in
    ``block_loop._top1_loop``) and greedy selection through the fused
    select kernel; False runs logits and the generic attention, as the JAX
    collector does. A sampled temperature draws from dense logits either
    way."""
    key = (prng.key(0, prompts.device) if key is None
           else key.to(prompts.device))
    outs = {"prompt": [], "gt": [], "final": [], "finalized_at": [],
            "hidden": []}
    extras = extras or {}
    if "prefix_embeds" in extras:
        raise ValueError("trajectory collection takes no prefix_embeds: "
                         "the reference's collector decodes without a "
                         "pos_offset")
    for tau in cdlm.temperatures:
        key, sub = prng.split(key)
        spec = SamplerSpec(prompt_len=prompts.shape[1],
                           gen_len=cdlm.gen_length,
                           block_size=cdlm.block_size,
                           temperature=float(tau), early_stop=False,
                           fused_select=fused_select)
        res, finalized_at, hidden = vanilla_blockwise(
            params, prompts, cfg=cfg, spec=spec, key=sub, extras=extras,
            record_hidden=True, graphs=graphs)
        outs["prompt"].append(prompts)
        outs["gt"].append(gt_answers)
        outs["final"].append(res.tokens[:, prompts.shape[1]:])
        outs["finalized_at"].append(finalized_at)
        outs["hidden"].append(hidden)
    return {k: torch.cat(v, dim=0) for k, v in outs.items()}


def sample_training_pair(dataset: Dict[str, torch.Tensor],
                         generator: torch.Generator, batch_size: int, *,
                         cfg: ModelConfig, cdlm: CDLMConfig):
    """Alg. 2 lines 4–6: draw trajectory entries ``idx`` and start steps
    ``t_start`` from ``generator``, then :func:`training_pair`."""
    n = dataset["final"].shape[0]
    dev = generator.device
    idx = torch.randint(0, n, (batch_size,), generator=generator, device=dev)
    t_start = torch.randint(0, cdlm.gen_length, (batch_size,),
                            generator=generator, device=dev)
    return training_pair(dataset, idx, t_start, cfg=cfg, cdlm=cdlm)


def training_pair(dataset: Dict[str, torch.Tensor], idx, t_start, *,
                  cfg: ModelConfig, cdlm: CDLMConfig):
    """The (y, y*) state pair of trajectory entries ``idx`` at start steps
    ``t_start`` (both (b,) int). Returns canvases ``y``/``y_star``
    (b, P+G), position masks ``u_mask``/``s_mask`` over the canvas, the
    teacher hidden slice (b, G, d) and ground-truth answers (b, G)."""
    G, B = cdlm.gen_length, cdlm.block_size
    dev = dataset["final"].device
    idx = torch.as_tensor(idx, device=dev).long()
    t_start = torch.as_tensor(t_start, device=dev).long()
    prompt = dataset["prompt"][idx]
    final = dataset["final"][idx]
    fat = dataset["finalized_at"][idx]
    t_end = block_completion_step(t_start, B).clamp_max(G)

    y_gen = state_at(final, fat, t_start[:, None], cfg.mask_token_id)
    ystar_gen = state_at(final, fat, t_end[:, None], cfg.mask_token_id)
    u_mask, s_mask = position_sets(fat, t_start, t_end)

    pad = torch.zeros(prompt.shape, dtype=torch.bool, device=dev)
    return {
        "y": torch.cat([prompt, y_gen], dim=1),
        "y_star": torch.cat([prompt, ystar_gen], dim=1),
        "u_mask": torch.cat([pad, u_mask], dim=1),
        "s_mask": torch.cat([pad, s_mask], dim=1),
        "teacher_hidden": dataset["hidden"][idx],
        "final": final,
        "gt": dataset["gt"][idx],
        "prompt": prompt,
    }
