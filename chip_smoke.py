#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each timed, any failure raises and exits non-zero:

1. card and build: the card's name and power limit, torch and CUDA
   versions, and an nvcc build of every kernel source of the checkout; the
   tensor-core kernels' (xent, block attention, select, decode attention,
   the grouped MoE's two products) registers, shared memory and spills,
   and the fp32 decode kernel's (ptxas: none may spill), each template
   instance apart
   (the dense and paged decode instances too, and every head dim the
   attention kernels take: 64, 112, 128, 256, each of ``INSTANCES`` must be
   reported), and every kernel's HGMMA instructions (cuobjdump: present in
   every bf16 instance, absent from every fp32 one);
2. every kernel against its plain PyTorch version on the card, at the main
   path's shapes (and small softcap / window / mode cases), each timed with
   CUDA events beside its plain version and one PyTorch yardstick call; the
   paged decode kernel also equals the dense one bit for bit on identity
   and permuted page tables; decode attention at qwen2-0.5b's, dream-7b's
   and llada-8b's head layouts, at lengths on and past the bf16 route's
   split edges (S not a multiple of 64, a lane at 0), and over NaN in
   every cache and pool row at or past cache_len (outputs equal to those
   over a finite residue); the fused cross-entropy forward and backward
   at the training path's shape (T=1,024, d=896, V=151,936) in bf16 and
   fp32, with sharp logits (W unscaled) in bf16, and at a ragged vocabulary
   (T=300, d=256, V=50,021) in both dtypes and sharp, the loss also against
   a float64 oracle, its backward twice bit for bit; block
   attention and select also at the trajectory collector's shapes (block
   attention timed there too), select's candidates and confidences also
   against a float64 oracle; phase 7's shapes: decode attention at one
   query row per lane (the AR step; qwen2-0.5b's, dream-7b's and
   llada-8b's head layouts, caches of 576 rows filled to 512..575, bf16
   timed, fp32 but for llada-8b),
   block attention over fast_dllm's canvas (b=8, L=576, bidirectional)
   and over ar's causal prefill (b=8, L=512), both timed against masked
   SDPA, and both modes at fp32; the shapes of phase 9's configs, each
   mixer kind with its own scale, softcap and window: gemma-7b (Kv 16,
   G 1, hd 256), gemma2-27b's local and global slots (Kv 16, G 2, hd 128,
   scale 144^-1/2, softcap 50, the local slot's window 4096),
   llama4-maverick (Kv 8, G 5, hd 128), kimi-k2 (Kv 8, G 8, hd 112;
   padded to 128 inside the kernels), jamba's attention slot (Kv 8,
   G 4, hd 128) and sdar-30b-a3b (Kv 4, G 8, hd 128), decode (dense and paged, bit for bit, split edges too)
   and prefill block attention (b=8, L=512), bf16 (the first mixer kind
   timed against masked SDPA, or where SDPA cannot compute the case, a
   softcap or a window, against a compiled ``flex_attention`` that must
   match the plain version within 1e-2) and fp32, jamba's AR step too
   (one query row a lane, caches of 192 rows, as phase 9's ``ar`` run
   calls it), and the fused select at T=256 over each config's (V, d)
   unembedding (rwkv6's too, which has no attention) with gemma2's final
   softcap 30, timed; phase 10's shapes, bf16, each timed against its
   plain version and one library call with its bound
   (``check_extras_kernels``): whisper-base's decoder self attention
   (Kv 8, G 1, hd 64 at 8 lanes of a 192-row cache), its encoder's
   bidirectional block attention over 1,500 ragged frames (8 lanes) and
   its decoder prefill, the select over its (51,865, 512) head and the
   cross-entropy at 128 rows of it; internvl2-1b's decode and paged
   decode (8 lanes, 832 rows), prefill (L 768) and select over its
   (151,655, 896) head; the long window's decode (window 8,192, 4 lanes
   of 8,512 rows) and prefill at L 8,448 (one lane) without and with the
   window; the forward's fused elementwise passes (add + RMSNorm, QKV
   bias + RoPE, act(g) * u; ``check_elementwise``) at dream-7b's widths
   at 32, 1,024 and 16,384 rows, timed beside their plain versions, their
   bytes bound and ``F.rms_norm``, and checked at llada-8b's, qwen2-0.5b's
   and gemma-7b's; sdar-30b-a3b's kernels: the QK-norm instance of QKV +
   RoPE (``check_qk_norm``, 1,024 rows timed, 4,096 checked) and the
   grouped MoE's five ``moe_*`` kernels (``check_moe``: the layout's
   counts and tiles, the output within ``MOE_REL`` of the plain
   version's largest) at a reduced shape and at 1,024, 2,048, 4,096,
   32,768 and 65,536 tokens of top-8 over 128 experts of 2,048 x 768
   (32, 64 and 128 lanes' blocks and 64 and 128 lanes' admissions), each
   timed beside its plain version and its bound;
3. the main path, dense layout: ``ContinuousEngine`` serving CDLM decoding
   of qwen2-0.5b at full width (24 layers, d=896, V=151,936, bf16, seeded
   random init), 12 requests of mixed ``max_tokens`` through 8 lanes, the
   prompt prefill through the block attention kernel, the decode through
   the dense decode attention and fused select kernels, replayed as the
   engine's CUDA graphs (one refinement iteration, the commit forward);
   the kernels' launch counters must equal the engine's call accounting;
3b. the main path, paged layout, same trace and width, through the graphs:
   with a dense-equivalent pool, tokens equal phase 3's and every cached
   forward goes through the paged kernel; with a tight pool (40 pages of
   32 tokens, the first 8 requests), at least one stall round and one
   preemption, the pool fully free at the end, tokens equal phase 3's;
3c. graph against eager: phase 3's trace and phase 3b's tight-pool case,
   each through an eager engine (``graphs=False``) and a graph engine in
   turns (eager, graph, graph, eager): tokens, steps, gen_length,
   finish_reason, call counts, page statistics and launch counts equal,
   launches equal to the call accounting on both paths; tokens/s, mean
   latency and a profiled block's device busy and idle share of each;
4. kernel path against plain path: the first block of a 2-request trace
   decoded at fp32 with the kernels (block attention prefill, dense and
   paged decode attention, fused select) and with their plain versions,
   token for token (a divergence is accepted only at a near-tie, printed
   with its gap); the dense and paged kernel paths agree bit for bit;
5. the training path at qwen2-0.5b's full width (bf16, seeded random
   init, b=4, P=128, G=256, B=32): 2 teacher SFT steps, one greedy
   collection batch (256 full-canvas forwards through the block attention
   and fused select kernels, the forward a CUDA graph), 2 full fine-tune
   and 1 LoRA student steps, every loss finite and the launch counters
   equal to the loss evaluations and collector forwards; the batch
   collected again eagerly and through the graph, trajectories bit for bit
   equal, with the ms per collection forward of each; the collected
   trajectories replayed step by step through the plain collector step
   (generic attention and logits, bf16 and fp32); the DLM term of a
   student step with the kernel and with the plain cross-entropy; warm
   step times and a profiled student step;
6. sampled serving and the HTTP frontend: (a) the threefry PRNG on the
   card equals the CPU's (keys and bits at the per-lane draw's shape bit
   for bit, Gumbel noise within 2 ulp), one per-lane draw timed; (b) phase
   3's trace with every other request at temperature 0.7 and its own
   seed, through an engine without fused select, graph, eager, graph,
   every run equal, launches equal to the call accounting, the greedy
   trace through the dense-logits iteration, four of the requests on the
   paged layout equal to the dense one, and a profiled sampled block; (c) the
   static engine's sampled decode: 8 requests at an engine default of 0.7,
   G=32, for ``vanilla``, ``fast_dllm``, ``dual_cache``,
   ``interval_cache`` and ``cdlm`` (``ar`` is greedy), each through an
   eager engine (``graphs=False``) and a graph engine in turns (eager,
   graph, graph, eager): tokens, steps, gen_length, finish_reason, calls
   and launches equal, launches equal to each decoder's accounting,
   tokens/s and ms per call of each path; (d) ``serve_http`` on a
   loopback port over (b)'s graph engine, a greedy and a seeded sampled
   completion streamed and not, equal to the eager engine's ``generate``,
   ``/healthz`` and ``/metrics``; (e) phase 5's collection shape at
   temperature 0.5 through the forward's graph and eagerly, bit for bit;
7. the paper's six decoders: (a) all six at full width through the
   static engine, 8 of phase 3's prompts, G=64, block 32, tau 0.9, greedy,
   fused select, bf16, each eagerly and through the engine's CUDA graphs
   in turns (eager, graph, graph, eager), every run equal: tokens/s, ms
   per call, steps and calls of each path (``cdlm``: a profiled batch of
   each path, its device busy and idle share), the calls and every
   kernel's launches held to each decoder's accounting (vanilla: G;
   fast_dllm: the iterations; dual_cache: 1 + (blocks - 1) + the
   iterations; interval_cache: 1 + the iterations; cdlm: 1 + the
   iterations + the blocks; ar: 1 + G); (b)
   each of them at fp32 (2 lanes, P=64) with the kernels and with their
   plain versions passed through ``run_block_loop(attention_fns=...)``:
   tokens, steps and calls equal (a divergence accepted only at a
   near-tie, found by a lockstep replay and printed with its gap); (c)
   ``interval_cache`` at a refresh interval of 1 against ``fast_dllm``,
   and ``ar`` against a plain greedy loop that re-runs a causal
   full-prefix forward at each step, equal or at a near-tie;
8. tuning and benches: (a) every entry of the cuda tuning table
   (``kernels/tuned_configs_cuda.json``) for this card and every config
   ``tuning.run_sweep`` would try at the main path's shapes, against the
   plain versions: decode attention (dense and paged, bf16 and fp32)
   within 1e-4 and dense == paged bit for bit under each split, select
   within ``select_limits``, xent within 1e-4 and ``grad_limit`` at 1,024
   and 4,096 rows (a table entry launched without a config, through the
   wrappers' own resolution, which must give its knobs); graph ==
   eager for the refinement iterations of one block under the table's
   split and under each other candidate split; (b)
   ``benchmarks/bench_serving_torch.py`` part (a) at full width with its
   scheduler trace cut to SERVING_BENCH_REQUESTS requests (printed), its
   records on a line of their own and its launches added to the summary;
   (c) the H100 config of ``repro_torch.configs``, whose peaks every bound
   reads, and its roofline ridge.

9. other architectures on the main path: ``ContinuousEngine`` serving
   greedy CDLM (fused select, bf16, seeded random init, every leaf built
   in its own dtype) through the attention kernels at every head dim they
   take: gemma-7b at full width and depth (28 layers, hd 256), gemma2-27b
   at full width and depth (46 layers: local slots with window 4096 and
   both softcaps), llama4-maverick at full width and one period (2 layers:
   an MLP slot and a 128-expert MOE slot) and kimi-k2 at full width and one
   layer (384 experts, top 8, hd 112), jamba at full width and one period
   (8 layers: 7 Mamba slots and an attention slot, 4 of them 16-expert
   MOE slots), rwkv6 at full width and depth (24 RWKV layers,
   attention-free, layernorm) and sdar-30b-a3b at full width and two of
   its 48 layers (QK-norm, every layer's 128 experts through the grouped
   ``moe_*`` kernels, held to their launch accounting): 8 requests of one or two 32-token blocks
   after a 128-token prompt through 8 lanes, on the dense then the paged
   layout (rwkv6: dense, the paged layout's refusal asserted), each
   through the engine's CUDA graphs (the MoE dispatch and the Mamba and
   RWKV loops over the state cache inside them); launches equal to the
   call accounting (the attention kernels once per attention layer),
   every token a vocabulary id, paged tokens equal to dense, tokens/s and
   peak memory beside the card's name and power limit; a profiled block
   of one-block requests through the dense engine's graphs per config
   (device ms by group, the recurrences' fused multiply-adds and the MoE
   dispatch as groups of their own, and the idle share); for jamba and
   rwkv6 the static ``Engine`` with ``ar`` (8 lanes, P=128, G=64) through
   its graphs against eager in turns, tokens, steps and calls equal and
   launches equal to the accounting; each config freed before the next.

10. request extras and the long window (``phase_extras``), bf16, seeded
   random init, frames and patches 0.1 N(0, 1) rounded to bf16: (a)
   whisper-base at full depth (6 encoder and 6 decoder layers, 1,500
   frames) through the static ``Engine``, 8 lanes, P=128, G=64, block
   32, greedy fused: the six decoders, each eagerly and through its
   graphs in turns (eager, graph, graph, eager: tokens, steps, calls and
   launches equal and held to each decoder's accounting, the encoder's
   layers in every full-sequence forward), tokens/s of each, ``cdlm``'s
   profiled block and the encoder's and cross attention's device ms in
   an eager block under profiler ranges, the continuous engine's and the
   paged layout's refusals; (b) internvl2-1b at full depth with 256
   prefix rows, 8 lanes, P=512, G=64, ``cdlm`` on the dense then the
   paged layout, each eager and graph in turns, paged tokens equal to
   dense; (c) the long window: 4 lanes of P=8,192 after the 256 prefix
   rows, ``use_long_window``, the static engine eager and graph in turns,
   then ``ContinuousEngine`` on the same prompts without the prefix,
   graph and eager, tokens equal; (d) one ``cdlm_loss`` value and
   gradient with whisper's frames (2 lanes, P=128, G=64), its DLM term
   with the kernel and with the plain cross-entropy within phase 5's
   limits.

11. the parallel and dry-run layer (``phase_parallel``): (a) the
   sequence-parallel decode (``repro_torch/parallel/seq_decode.py``) in
   four spawned ranks on the one card, gloo over CUDA tensors (NCCL
   refuses two ranks on one device), each holding a quarter of a cache at
   qwen2-0.5b's attention shape (8 lanes, 32 queries, Kv 2, G 7, hd 64,
   S 32,768, bf16, lengths on, below and across the shard edges), the
   merged output held against the decode kernel over the whole cache
   without and with a window of 4,096 (within the output's bf16 rounding
   plus 1e-4), ms per sharded call beside the kernel's (four ranks sharing
   one card say nothing of four cards); (b) the dry-run's plan of
   qwen2-0.5b x decode_32k at a 1x1 mesh, counted on the meta device, its
   three roofline terms with the H100's constants beside the median of
   10 steps of the same step on the card (full width, batch 128, the
   32,768-row cache filled in place with ``normal_`` in bf16, the decode
   through the kernel, CUDA events; the batch cut, and the cut printed,
   only if the card's free memory forces it), the kernel's launches equal
   to one per layer and step, and one profiled step's device ms by kernel
   group; (c) the three examples
   (``examples/*_torch.py``) on the card at small budgets (60 teacher
   steps), every kernel launched and every decode of every example
   emitting tokens (mean tokens before EOS above 0).

The line before the last two is the kernels' JSON summary (phase 9's
configs' entries keyed "<kernel> <config>", jamba's and rwkv6's with the
checked shape too, ``arch_key``; phase 10's keyed by ``EXTRAS_KEYS``,
e.g. "decode_attention whisper-base", "block_attention internvl2-1b
L8448"), then the card's
``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device, or outside a checkout, it exits non-zero and prints
no result.
"""
import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

DECODE_SRC = "src/repro_torch/kernels/decode_attn/csrc/decode_attn.cu"
DECODE_TPU = "src/repro/kernels/decode_attn/decode_attn.py:93"
SELECT_SRC = "src/repro_torch/kernels/select/csrc/select.cu"
SELECT_TPU = "src/repro/kernels/select/select.py:88"
PAGED_TPU = "src/repro/kernels/decode_attn/decode_attn.py:198"
BLOCK_SRC = "src/repro_torch/kernels/block_attn/csrc/block_attn.cu"
BLOCK_TPU = "src/repro/kernels/block_attn/block_attn.py:96"
XENT_SRC = "src/repro_torch/kernels/xent/csrc/xent.cu"
XENT_TPU = "src/repro/kernels/xent/xent.py:59"
XENT_BWD_TPU = "src/repro/kernels/xent/ops.py:71"
# the CUDA kernels' names: bf16 route (tensor cores, *_tc) and fp32 route
XENT_TC_KERNELS = ["xent_partial_tc", "xent_probs_tc", "xent_grad_tc"]
XENT_FP32_KERNELS = ["xent_partial_kernel", "xent_probs_kernel",
                     "xent_dh_kernel", "xent_dw_kernel"]
BLOCK_KERNELS = ["block_attn_tc", "block_attn_kernel"]
SELECT_KERNELS = ["select_partial_tc", "select_partial_kernel",
                  "select_merge_kernel"]
DECODE_KERNELS = ["decode_attn_tc", "decode_attn_kernel",
                  "decode_merge_kernel"]
ELEMENTWISE_SRC = "src/repro_torch/kernels/elementwise/csrc/elementwise.cu"
# the passes replace no Pallas kernel: XLA fused these ops on the TPU
ELEMENTWISE_TPU = "none (XLA fused the ops)"
ELEMENTWISE_KERNELS = {"add_rmsnorm": ["add_rmsnorm_kernel"],
                       "qkv_rope": ["qkv_rope_kernel"],
                       "gated_act": ["gated_act_kernel"]}
MOE_SRC = "src/repro_torch/kernels/moe/csrc/moe.cu"
MOE_TPU = "none (the JAX package's capacity scatter drops tokens)"
# the grouped MoE's launches, in order; every name starts with "moe_"
MOE_KERNELS = ["moe_align", "moe_gather", "moe_gate_up", "moe_down",
               "moe_combine"]
# source -> its tensor-core kernels, and the fp32 kernels beside them
TC_KERNELS = {"moe.cu": ["moe_gate_up", "moe_down"],
              "xent.cu": XENT_TC_KERNELS, "block_attn.cu": ["block_attn_tc"],
              "select.cu": ["select_partial_tc"],
              "decode_attn.cu": ["decode_attn_tc"]}
FP32_KERNELS = XENT_FP32_KERNELS + ["block_attn_kernel",
                                    "select_partial_kernel",
                                    "decode_attn_kernel"]
# source -> further kernels whose ptxas report must show no spills
NO_SPILL = {"decode_attn.cu": ["decode_attn_kernel"],
            "elementwise.cu": ["add_rmsnorm_kernel", "qkv_rope_kernel",
                               "gated_act_kernel"]}
# template instances ptxas and cuobjdump must report: the attention
# kernels at every head dim they take
INSTANCES = ([f"block_attn_tc<{hd}>" for hd in (64, 112, 128, 256)]
             + [f"decode_attn_tc<{hd},{lay}>" for hd in (64, 112, 128, 256)
                for lay in ("dense", "paged")]
             + [f"decode_attn_kernel<{hd},{rows},{lay}>"
                for hd, rows in ((64, 32), (112, 8), (128, 16), (256, 16))
                for lay in ("dense", "paged")])
# phase 9's configs: (name, layers kept or None for full depth); phase 2
# checks the kernels at each one's shapes (``arch_attention_cases``), and
# the kernels' summary carries one entry per kernel and config (the
# recurrent-state configs' keyed by their shapes too, ``arch_key``)
ARCH_RUNS = (("gemma-7b", None), ("gemma2-27b", None),
             ("llama4-maverick-400b-a17b", 2), ("kimi-k2-1t-a32b", 1),
             ("jamba-v0.1-52b", 8), ("rwkv6-1.6b", None),
             ("sdar-30b-a3b", 2))
ARCH_KERNELS = ("decode_attention", "paged_decode_attention",
                "block_attention", "fused_select")
# configs whose summary entries name the checked shape: each entry's
# launches, error, time and library time come from that one shape
SHAPE_KEYED = ("jamba-v0.1-52b", "rwkv6-1.6b")
# phase 9's static ``ar`` run: lanes, prompt and generation
AR_RUN = (8, 128, 64)
# phase 9's profile, by kernel name: the recurrences' fused multiply-adds
# (the Mamba scan's and RWKV's state updates) and the MoE dispatch's sort,
# ranks, scatter and gathers
RECURRENCE_MARKS = ("addcmul",)
MOE_MARKS = ("sort", "Sort", "scatter", "index", "gather", "cumsum", "Scan")
XENT_FWD_KERNELS = ["xent_partial_tc", "xent_partial_kernel",
                    "xent_merge_kernel"]
XENT_BWD_KERNELS = ["xent_probs_tc", "xent_grad_tc", "xent_probs_kernel",
                    "xent_dh_kernel", "xent_dw_kernel", "xent_dh_final_kernel"]
KERNELS = ("decode_attention", "fused_select", "paged_decode_attention",
           "block_attention", "xent_forward", "xent_backward", "add_rmsnorm",
           "qkv_rope", "gated_act")
NEAR_TIE = 1e-4
# qkv_rope's QK-norm instance: q and k within 2 bf16 ulps of the plain
# version's largest value (a normed value one ulp off moves its rotation
# by up to one ulp of the head's values, which is many ulps of a rotated
# value near 0)
QK_NORM_ULPS = 2
# the grouped MoE against its plain version, relative to max|y|: both
# round at the same points and sum each product in fp32, and every card
# run so far read 0
MOE_REL = 1e-4
# the per-lane draw's kernels in a trace: threefry's int32 elementwise ops,
# the uniform's shifts and masks and the Gumbel's logs and clamp
DRAW_KERNEL_MARKS = ("bitwise", "shift", "<int>", "(int, int)",
                     "log_kernel", "clamp")


def log(msg):
    print(msg, flush=True)


def nvidia_smi():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters):
    """Mean ms per call over ``iters`` back-to-back calls (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters, kernels):
    """Device time per call of the CUDA kernels whose names contain one of
    ``kernels``, from the profiler's trace (None if it records none)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for ev in prof.key_averages():
        if any(k in ev.key for k in kernels):
            total += getattr(ev, "self_device_time_total",
                             getattr(ev, "self_cuda_time_total", 0.0))
    return total / iters / 1e3 if total else None


def alternate(torch, plain, kernel, library, iters):
    """plain, kernel, library, library, kernel, plain: means per side."""
    order = [("plain", plain), ("kernel", kernel), ("library", library),
             ("library", library), ("kernel", kernel), ("plain", plain)]
    got = {}
    for name, fn in order:
        if fn is not None:
            got.setdefault(name, []).append(time_ms(torch, fn, iters))
    return {k: sum(v) / len(v) for k, v in got.items()}


def bound_ms(n_bytes, n_ops, dtype):
    """(ms, "bytes" or "operations") on the H100 of ``repro_torch.configs``,
    the one copy of the card's peaks."""
    from repro_torch.roofline import bound_ms as bound
    return bound(n_bytes, n_ops, dtype)


_FLEX = {}


def flex_library(torch, q, k, v, want, *, scale, softcap, mask_mod, name):
    """The yardstick of a softcapped or windowed attention case, which SDPA
    cannot compute: one call of torch's ``flex_attention``, compiled as its
    documentation runs it, with the softcap as its ``score_mod`` and the
    visibility as a block mask. q: (b, H, Lq, hd); k, v: (b, Kv, Lk, hd);
    ``want``: the plain version's (b, Lq, Kv, G, hd), which its output must
    match within 1e-2 (bf16 outputs), so that the yardstick computes the
    case's function. Timed only: nothing of the port calls it. Returns
    (the call, its max abs error)."""
    from torch.nn.attention.flex_attention import (
        create_block_mask,
        flex_attention,
    )
    if "fn" not in _FLEX:
        # inductor's and triton's caches inside the checkout's build dir
        import os
        for var, sub_dir in (("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                             ("TRITON_CACHE_DIR", "triton")):
            os.environ.setdefault(var, str(ROOT / "build" / sub_dir))
        _FLEX["fn"] = torch.compile(flex_attention, dynamic=False)
    if softcap not in _FLEX:
        _FLEX[softcap] = (None if softcap is None else lambda s, b, h, qi, ki:
                          softcap * torch.tanh(s / softcap))
    b, H, Lq, hd = q.shape
    mask = create_block_mask(mask_mod, b, None, Lq, k.shape[2],
                             device=q.device)
    call = lambda: _FLEX["fn"](q, k, v, score_mod=_FLEX[softcap],  # noqa
                               block_mask=mask, scale=scale, enable_gqa=True)
    out = call()
    Kv = k.shape[1]
    out = out.float().reshape(b, Kv, H // Kv, Lq, hd).permute(0, 3, 1, 2, 4)
    err = (out - want).abs().max().item()
    if not err <= 1e-2:
        raise AssertionError(f"flex_attention yardstick {name}: max error "
                             f"{err} > 1e-2 against the plain version")
    return call, err


def decode_mask_mod(cl, S, window):
    """flex_attention's visibility of a decode case over the keys
    ``[cache rows | the block's]`` (S + Bq), as the plain version's: cache
    row j if j < cache_len and (cache_len + i) - j < window; block key j
    if |i - j| < window."""
    def mod(b, h, qi, ki):
        n = cl[b]
        in_cache = ki < S
        vis_cache = ki < n
        vis_blk = ki >= S
        if window is not None:
            vis_cache = vis_cache & (n + qi - ki < window)
            vis_blk = vis_blk & ((qi - (ki - S)).abs() < window)
        return (in_cache & vis_cache) | (~in_cache & vis_blk)
    return mod


# ---------------------------------------------------------------------------
# phase 1: what the compiler made of the tensor-core kernels
# ---------------------------------------------------------------------------
def _kernel_of(mangled, names):
    """The kernel of ``names`` a mangled name is, labelled with its int and
    bool template arguments (``block_attn_tc<64>``, ``decode_attn_tc<64,
    paged>``: the bool of the decode kernels is PAGED), or None."""
    name = next((n for n in names if n in mangled), None)
    if name is None:
        return None
    args = [v if t == "i" else ("paged" if v == "1" else "dense")
            for t, v in re.findall(r"L([ib])(\d+)E",
                                   mangled.split(name, 1)[1])]
    return f"{name}<{','.join(args)}>" if args else name


def ptxas_report(report, names):
    """Registers, static shared memory and spills of the kernels ``names``
    (each template instance apart) from ptxas' -v report."""
    out, cur = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = _kernel_of(m.group(1), names)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out.setdefault(cur, {}).update(spill_stores=int(m[1]),
                                           spill_loads=int(m[2]))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            smem = re.search(r"(\d+) bytes smem", line)
            out.setdefault(cur, {}).update(
                registers=int(m[1]),
                static_smem_bytes=int(smem[1]) if smem else 0)
    return out


def ptxas_check(ptxas):
    """The tensor-core kernels' ptxas reports (and NO_SPILL's): every kernel
    (and template instance) reported, with its registers and no spills."""
    out = {}
    for src in TC_KERNELS.keys() | NO_SPILL.keys():
        names = TC_KERNELS.get(src, []) + NO_SPILL.get(src, [])
        rep = ptxas_report(ptxas.get(src, ""), names)
        for name in names:
            if not any(k.split("<")[0] == name for k in rep):
                raise AssertionError(f"ptxas: no report of {name} in {src}")
        bad = {label: r for label, r in rep.items()
               if "registers" not in r or r.get("spill_stores", 1)
               or r.get("spill_loads", 1)}
        if bad:
            raise AssertionError(f"ptxas: {bad}")
        out.update(rep)
    missing = [k for k in INSTANCES if k not in out]
    if missing:
        raise AssertionError(f"ptxas: no report of {missing}")
    return out


def sass_hgmma(so):
    """HGMMA (wgmma) instructions in each tensor-core and fp32 kernel's
    SASS (each template instance apart), from cuobjdump of the built
    library: the bf16 kernels must have them, the fp32 ones none."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([exe, "-sass", str(so)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    tc = [n for names in TC_KERNELS.values() for n in names]
    counts, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = _kernel_of(m.group(1), tc + FP32_KERNELS)
            if cur is not None:
                counts.setdefault(cur, 0)
        elif cur is not None and "HGMMA" in line:
            counts[cur] += 1
    base = {k: k.split("<")[0] for k in counts}
    if not (all(k in counts for k in INSTANCES)
            and all(any(b == n for b in base.values())
                    for n in tc + FP32_KERNELS)
            and all(c > 0 for k, c in counts.items() if base[k] in tc)
            and all(c == 0 for k, c in counts.items()
                    if base[k] in FP32_KERNELS)):
        raise AssertionError(f"SASS: HGMMA counts {counts}")
    return counts


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def check_decode(torch, dev, *, b, Bq, Kv, G, hd, S, lens, dtype,
                 softcap=None, window=None, scale=None, timed=False,
                 name=""):
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attn import decode_attention
    from repro_torch.kernels.decode_attn import ref as dref
    dt = getattr(torch, dtype)
    g = torch.Generator(device=dev).manual_seed(len(name))
    rnd = lambda *s: torch.randn(s, generator=g, device=dev).to(dt)  # noqa
    q = rnd(b, Bq, Kv, G, hd)
    kc = rnd(2, b, S, Kv, hd)[1]          # a period slice: strided lanes
    vc = rnd(2, b, S, Kv, hd)[1]
    kb, vb = rnd(b, Bq, Kv, hd), rnd(b, Bq, Kv, hd)
    cl = torch.tensor(lens, dtype=torch.int32, device=dev)
    scale = hd ** -0.5 if scale is None else scale
    kw = dict(scale=scale, softcap=softcap, window=window)
    got = decode_attention(q, kc, vc, kb, vb, cl, **kw)
    want = dref.decode_attention(q, kc, vc, kb, vb, cl, **kw)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    # both sides read the same inputs and accumulate in fp32
    tol = 1e-4
    if not err <= tol:
        raise AssertionError(f"decode_attention {name}: max error {err} "
                             f"> {tol}")
    rec = {"kernel": "decode_attention", "case": name, "dtype": dtype,
           "shape": dict(b=b, Bq=Bq, Kv=Kv, G=G, hd=hd, S=S, lens=lens),
           "max_abs_err": err, "tol": tol}
    if timed:
        H, Lk = Kv * G, S + Bq
        qs = q.permute(0, 2, 3, 1, 4).reshape(b, H, Bq, hd)
        ks = torch.cat([kc, kb], 1).permute(0, 2, 1, 3).contiguous()
        vs = torch.cat([vc, vb], 1).permute(0, 2, 1, 3).contiguous()
        slot = torch.arange(Lk, device=dev)
        mask = ((slot[None, :] < cl[:, None]) | (slot[None, :] >= S))
        mask = mask[:, None, None, :].expand(b, 1, Bq, Lk)
        if window is not None:
            # the plain version's window: cache row j of query i if
            # (cache_len + i) - j < window, block key j if |i - j| < window
            i = torch.arange(Bq, device=dev)[:, None]
            near = torch.where(slot[None, :] < S,
                               cl[:, None, None] + i - slot < window,
                               (i - (slot - S)).abs() < window)
            mask = mask & near[:, None]
        # SDPA has no softcap: flex_attention
        library = lambda: F.scaled_dot_product_attention(  # noqa
            qs, ks, vs, attn_mask=mask, scale=scale, enable_gqa=True)
        if softcap:
            library, rec["library_max_abs_err"] = flex_library(
                torch, qs, ks, vs, want, scale=scale, softcap=softcap,
                mask_mod=decode_mask_mod(cl, S, window), name=name)
        times = alternate(
            torch, lambda: dref.decode_attention(q, kc, vc, kb, vb, cl, **kw),
            lambda: decode_attention(q, kc, vc, kb, vb, cl, **kw),
            library, iters=50)
        item = q.element_size()
        n_keys = sum(lens) + b * Bq
        n_bytes = (q.numel() * item + 2 * Kv * hd * item * sum(lens)
                   + (kb.numel() + vb.numel()) * item + got.numel() * 4
                   + 4 * b)
        n_ops = 4 * Kv * Bq * G * hd * n_keys
        bms, by = bound_ms(n_bytes, n_ops, dtype)
        rec.update(kernel_ms=times["kernel"], plain_ms=times["plain"],
                   library_ms=times.get("library"), bound_ms=bms,
                   bound_by=by,
                   kernel_device_ms=device_ms(
                       torch, lambda: decode_attention(q, kc, vc, kb, vb, cl,
                                                       **kw),
                       50, DECODE_KERNELS),
                   merge_device_ms=device_ms(
                       torch, lambda: decode_attention(q, kc, vc, kb, vb, cl,
                                                       **kw),
                       50, ["decode_merge_kernel"]),
                   library_device_ms=library and device_ms(torch, library,
                                                           50, [""]))
    log(json.dumps(rec))
    return rec


def _paged_pool(torch, dev, kc, vc, lens, page, perm_gen):
    """The dense caches' rows moved page by page into a pool of 3x the pages
    needed, at shuffled places; table entries past each lane's length are
    -1. Returns (k_pool, v_pool, table)."""
    b, S, Kv, hd = kc.shape
    n_t = S // page
    n_pages = 3 * b * n_t
    perm = torch.randperm(n_pages, generator=perm_gen, device=dev)[:b * n_t]
    kp = torch.randn((n_pages, page, Kv, hd), generator=perm_gen,
                     device=dev).to(kc.dtype)      # residue of other lanes
    vp = torch.randn((n_pages, page, Kv, hd), generator=perm_gen,
                     device=dev).to(kc.dtype)
    kp[perm] = kc.reshape(b * n_t, page, Kv, hd)
    vp[perm] = vc.reshape(b * n_t, page, Kv, hd)
    table = perm.to(torch.int32).reshape(b, n_t).clone()
    used = torch.arange(n_t, device=dev)[None, :] * page < lens[:, None]
    table[~used] = -1
    return kp, vp, table


def check_paged(torch, dev, *, b, Bq, Kv, G, hd, S, lens, dtype, page=32,
                softcap=None, window=None, scale=None, timed=False, name="",
                config=None):
    """The paged kernel against its plain version over a shuffled table with
    -1 tail entries, and bit for bit against the dense kernel on the same
    contents (identity table, then the shuffled one). ``config``: the
    ``tuning.KernelConfig`` both kernels launch with (None: the table's)."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attn import (
        decode_attention,
        paged_decode_attention,
    )
    from repro_torch.kernels.decode_attn import ref as dref
    dt = getattr(torch, dtype)
    g = torch.Generator(device=dev).manual_seed(len(name) + 7)
    rnd = lambda *s: torch.randn(s, generator=g, device=dev).to(dt)  # noqa
    q = rnd(b, Bq, Kv, G, hd)
    kc, vc = rnd(b, S, Kv, hd), rnd(b, S, Kv, hd)
    kb, vb = rnd(b, Bq, Kv, hd), rnd(b, Bq, Kv, hd)
    cl = torch.tensor(lens, dtype=torch.int32, device=dev)
    kw = dict(scale=hd ** -0.5 if scale is None else scale, softcap=softcap,
              window=window)
    kp, vp, table = _paged_pool(torch, dev, kc, vc, cl, page, g)
    got = paged_decode_attention(q, kp, vp, kb, vb, table, cl, **kw,
                                 config=config)
    want = dref.paged_decode_attention(q, kp, vp, kb, vb, table, cl, **kw)
    dense = decode_attention(q, kc, vc, kb, vb, cl, **kw, config=config)
    ident = torch.arange(b * (S // page), dtype=torch.int32,
                         device=dev).reshape(b, S // page)
    same_ident = torch.equal(paged_decode_attention(
        q, kc.reshape(-1, page, Kv, hd), vc.reshape(-1, page, Kv, hd), kb,
        vb, ident, cl, **kw, config=config), dense)
    same_perm = torch.equal(got, dense)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    # both sides read the same inputs and accumulate in fp32
    tol = 1e-4
    if not err <= tol:
        raise AssertionError(f"paged_decode_attention {name}: max error "
                             f"{err} > {tol}")
    if not (same_ident and same_perm):
        raise AssertionError(f"paged_decode_attention {name}: not equal to "
                             f"the dense kernel bit for bit (identity "
                             f"{same_ident}, shuffled {same_perm})")
    rec = {"kernel": "paged_decode_attention", "case": name, "dtype": dtype,
           "shape": dict(b=b, Bq=Bq, Kv=Kv, G=G, hd=hd, page=page,
                         n_t=S // page, n_pages=kp.shape[0], lens=lens),
           "max_abs_err": err, "tol": tol,
           "bitwise_equal_dense": {"identity": same_ident,
                                   "shuffled": same_perm}}
    if timed:
        H, Lk = Kv * G, S + Bq
        qs = q.permute(0, 2, 3, 1, 4).reshape(b, H, Bq, hd)
        ks = torch.cat([kc, kb], 1).permute(0, 2, 1, 3).contiguous()
        vs = torch.cat([vc, vb], 1).permute(0, 2, 1, 3).contiguous()
        slot = torch.arange(Lk, device=dev)
        mask = ((slot[None, :] < cl[:, None]) | (slot[None, :] >= S))
        mask = mask[:, None, None, :].expand(b, 1, Bq, Lk)
        # the yardstick reads the gathered dense view (the gather untimed);
        # SDPA has no softcap, and its mask here no window: flex_attention
        library = lambda: F.scaled_dot_product_attention(  # noqa
            qs, ks, vs, attn_mask=mask, scale=kw["scale"], enable_gqa=True)
        if softcap or window:
            library, rec["library_max_abs_err"] = flex_library(
                torch, qs, ks, vs, want, scale=kw["scale"], softcap=softcap,
                mask_mod=decode_mask_mod(cl, S, window), name=name)
        times = alternate(
            torch, lambda: dref.paged_decode_attention(q, kp, vp, kb, vb,
                                                       table, cl, **kw),
            lambda: paged_decode_attention(q, kp, vp, kb, vb, table, cl,
                                           **kw),
            library, iters=50)
        item = q.element_size()
        n_keys = sum(lens) + b * Bq
        n_bytes = (q.numel() * item + 2 * Kv * hd * item * sum(lens)
                   + (kb.numel() + vb.numel()) * item + got.numel() * 4
                   + 4 * b + 4 * sum(-(-n // page) for n in lens))
        n_ops = 4 * Kv * Bq * G * hd * n_keys
        bms, by = bound_ms(n_bytes, n_ops, dtype)
        rec.update(kernel_ms=times["kernel"], plain_ms=times["plain"],
                   library_ms=times.get("library"), bound_ms=bms,
                   bound_by=by,
                   kernel_device_ms=device_ms(
                       torch, lambda: paged_decode_attention(
                           q, kp, vp, kb, vb, table, cl, **kw),
                       50, DECODE_KERNELS),
                   merge_device_ms=device_ms(
                       torch, lambda: paged_decode_attention(
                           q, kp, vp, kb, vb, table, cl, **kw),
                       50, ["decode_merge_kernel"]),
                   library_device_ms=library and device_ms(torch, library,
                                                           50, [""]))
    log(json.dumps(rec))
    return rec


def check_block(torch, dev, *, b, L, Kv, G, hd, dtype, mode, prompt_len=0,
                block_size=1, window=None, softcap=None, scale=None,
                timed=False, name=""):
    """The block attention kernel against its plain version (both keep
    scores and probabilities in fp32)."""
    import torch.nn.functional as F

    from repro_torch.kernels.block_attn import flash_block_attention
    from repro_torch.kernels.block_attn import ref as bref
    dt = getattr(torch, dtype)
    g = torch.Generator(device=dev).manual_seed(len(name) + L)
    rnd = lambda *s: torch.randn(s, generator=g, device=dev).to(dt)  # noqa
    q = rnd(b, L, Kv, G, hd)
    k, v = rnd(b, L, Kv, hd), rnd(b, L, Kv, hd)
    kw = dict(mode=mode, prompt_len=prompt_len, block_size=block_size,
              window=window, scale=hd ** -0.5 if scale is None else scale,
              softcap=softcap)
    got = flash_block_attention(q, k, v, **kw)
    want = bref.block_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    tol = 1e-4
    if not err <= tol:
        raise AssertionError(f"block_attention {name}: max error {err} > "
                             f"{tol}")
    rec = {"kernel": "block_attention", "case": name, "dtype": dtype,
           "shape": dict(b=b, L=L, Kv=Kv, G=G, hd=hd, mode=mode,
                         prompt_len=prompt_len, block_size=block_size,
                         window=window, softcap=softcap),
           "max_abs_err": err, "tol": tol}
    if timed:
        vis = bref.visibility(L, L, mode=mode, prompt_len=prompt_len,
                              block_size=block_size, window=window,
                              device=dev)
        qs = q.permute(0, 2, 3, 1, 4).reshape(b, Kv * G, L, hd)
        ks = k.permute(0, 2, 1, 3).contiguous()
        vs = v.permute(0, 2, 1, 3).contiguous()
        # SDPA has no softcap: flex_attention for a softcapped case
        library = lambda: F.scaled_dot_product_attention(  # noqa
            qs, ks, vs, attn_mask=vis, scale=kw["scale"], enable_gqa=True)
        if softcap:
            library, rec["library_max_abs_err"] = flex_library(
                torch, qs, ks, vs, want, scale=kw["scale"], softcap=softcap,
                mask_mod=lambda b_, h_, qi, ki: vis[qi, ki], name=name)
        times = alternate(
            torch, lambda: bref.block_attention(q, k, v, **kw),
            lambda: flash_block_attention(q, k, v, **kw), library, iters=10)
        item = q.element_size()
        n_bytes = (q.numel() + k.numel() + v.numel()) * item + got.numel() * 4
        n_ops = 4 * hd * int(vis.sum()) * b * Kv * G
        bms, by = bound_ms(n_bytes, n_ops, dtype)
        rec.update(kernel_ms=times["kernel"], plain_ms=times["plain"],
                   library_ms=times.get("library"), bound_ms=bms,
                   bound_by=by, visible_pairs=int(vis.sum()),
                   kernel_device_ms=device_ms(
                       torch, lambda: flash_block_attention(q, k, v, **kw),
                       10, BLOCK_KERNELS),
                   library_device_ms=library and device_ms(torch, library,
                                                           10, [""]))
    log(json.dumps(rec))
    return rec


U32 = 2.0 ** -24                          # fp32 unit roundoff


def select_limits(torch, h, w, cand, V):
    """Per-row limits for comparing two fp32 evaluations of the selection,
    set from the rounding error of logits of this size.

    Each logit is a sum of d products, accumulated in fp32 one term after
    the other (the kernel's fma chain; cuBLAS sums in blocks, with less
    error). Rounding the partial sum s_k costs at most u |s_k|; taken as
    independent and uniform, the logit is off by a standard deviation of
    sigma = u / sqrt(3) * R with R = sqrt(sum_k s_k^2), here R of the row's
    top logit. log(conf) = z_top - logsumexp(z) moves by at most two such
    terms, and the sum-exp over the vocabulary adds at most
    u / sqrt(3) * sqrt(V / 64) (at most one rounding per 64-wide vocab
    tile, chained). Two sides (kernel and plain) give sqrt(2); the limit
    is six standard deviations:
        conf_rel_t = 6 sqrt(2) u / sqrt(3) (2 R_t + sqrt(V / 64)).
    The top-2 gap of two logits moves by at most 6 * 2 sigma, so a row
    whose gap is below max(NEAR_TIE, that) may pick either candidate.
    """
    part = torch.cumsum(h.double() * w[cand.long()].double(), dim=-1)
    R = part.square().sum(-1).sqrt()
    sig = U32 / 3 ** 0.5
    conf_rel = 6 * 2 ** 0.5 * sig * (2 * R + (V / 64) ** 0.5)
    gap = torch.clamp(6 * 2 * sig * R, min=NEAR_TIE)
    return conf_rel.float(), gap.float()


def select_f64(torch, h, w, chunk=8192, softcap=None):
    """(cand, conf) in float64, vocab chunk by chunk, first occurrence: an
    oracle for fp32 sums (bf16 products are exact in float64); the logits
    softcapped to ``softcap * tanh(z / softcap)`` where given."""
    hd = h.double()
    m = torch.full((h.shape[0],), -torch.inf, dtype=torch.float64,
                   device=h.device)
    l = torch.zeros_like(m)
    best = torch.zeros(h.shape[0], dtype=torch.int64, device=h.device)
    for j in range(0, w.shape[0], chunk):
        lo = hd @ w[j:j + chunk].double().t()
        if softcap is not None:
            lo = softcap * torch.tanh(lo / softcap)
        tm, ti = lo.amax(-1), lo.argmax(-1)
        m_new = torch.maximum(m, tm)
        l = l * torch.exp(m - m_new) + torch.exp(lo - m_new[:, None]).sum(-1)
        best = torch.where(tm > m, ti + j, best)
        m = m_new
    return best.to(torch.int32), 1.0 / l


def check_select(torch, dev, *, T, d, V, dtype, scale, softcap=None,
                 timed=False, name="", config=None):
    """``scale`` sets W's spread: at 0.02 the logits spread about 0.6 and
    confidences sit near 1/V (as at random init); at 1 they spread about
    sqrt(d) and most rows are near-certain, as in a trained model, where
    threshold finalization and the confidence comparison bite. ``config``:
    the ``tuning.KernelConfig`` the kernel launches with (None: the
    table's). ``softcap``: the final logit softcap, on every side; the
    limits stay those of the uncapped logits (tanh's slope is at most 1,
    and its rounding, near 2^-24 of the cap, is far inside them)."""
    from repro_torch.kernels.select import fused_select
    from repro_torch.kernels.select import ref as sref
    dt = getattr(torch, dtype)
    g = torch.Generator(device=dev).manual_seed(V % 1000)
    h = torch.randn((T, d), generator=g, device=dev).to(dt)
    w = (torch.randn((V, d), generator=g, device=dev) * scale).to(dt)
    masked = torch.rand((T,), generator=g, device=dev) < 0.7
    # a planted tie across vocab chunks: rows 1 and V-7 are equal and are
    # row 0's maximum (a logit near 0.4 d scale, far above the spread); the
    # lower index must win
    w[1] = w[V - 7] = (h[0].float().sign() * scale / 2).to(dt)
    got_c, got_f = fused_select(h, w, masked, softcap=softcap,
                                config=config)
    want_c, want_f = sref.select_streaming(h, w, masked, softcap=softcap)
    exact_c, exact_f = select_f64(torch, h, w, softcap=softcap)
    cap = ((lambda z: z) if softcap is None else
           (lambda z: softcap * torch.tanh(z / softcap)))
    logits = cap(h.float() @ w.float().t())
    top2 = logits.topk(2, dim=-1).values
    del logits
    conf_tol, gap_tol = select_limits(torch, h, w, got_c, V)
    gap = (top2[:, 0] - top2[:, 1]).cpu()
    torch.cuda.synchronize()
    diff = (got_c != want_c).cpu()
    ties = [(int(t), float(gap[t])) for t in diff.nonzero().flatten()]
    for t, gp in ties:
        log(f"select {name}: row {t} kernel cand {int(got_c[t])} != plain "
            f"{int(want_c[t])} at a top-2 logit gap of {gp} (limit "
            f"{float(gap_tol[t])})")
    if any(gp >= float(gap_tol[t]) for t, gp in ties):
        raise AssertionError(f"select {name}: candidates differ away from "
                             "a near-tie")
    if int(got_c[0]) != 1:
        raise AssertionError(f"select {name}: planted tie gave "
                             f"{int(got_c[0])}, expected 1")
    fin = torch.isfinite(want_f)
    if not torch.equal(fin, masked) or not torch.equal(
            torch.isfinite(got_f), masked):
        raise AssertionError(f"select {name}: finalized rows not -inf")
    same = fin & ~diff.to(dev)
    rel_t = (got_f - want_f).abs() / want_f.abs()
    if not bool((rel_t[same] <= conf_tol[same]).all()):
        worst = int(torch.where(same, rel_t / conf_tol, 0).argmax())
        raise AssertionError(
            f"select {name}: conf relative error {float(rel_t[worst])} > "
            f"limit {float(conf_tol[worst])} at row {worst}")
    rel = rel_t[same].max().item()
    err = (got_f - want_f).abs()[same].max().item()
    # the float64 oracle: the kernel's own error, and the plain version's
    # beside it (rows off the oracle's candidate only at a near-tie, each
    # side's confidence within the same per-row limit)
    f64 = {}
    for side, (c_, f_) in (("kernel", (got_c, got_f)),
                           ("plain", (want_c, want_f))):
        off = (c_ != exact_c) & masked
        away = off & (gap.to(dev) >= gap_tol.to(dev))
        ok = masked & ~off
        rel64 = (f_.double() - exact_f).abs() / exact_f
        f64[side] = {"cand_off_oracle": int(off.sum()),
                     "cand_off_oracle_away_from_near_tie": int(away.sum()),
                     "max_rel_err": rel64[ok].max().item(),
                     "worst_share_of_limit":
                         (rel64[ok] / conf_tol[ok].double()).max().item()}
    k64 = f64["kernel"]
    if k64["cand_off_oracle_away_from_near_tie"] or \
            k64["worst_share_of_limit"] > 1:
        raise AssertionError(f"select {name}: against float64 {f64}")
    conf = want_f[fin]
    rec = {"kernel": "fused_select", "case": name, "dtype": dtype,
           "shape": dict(T=T, d=d, V=V, w_scale=scale, softcap=softcap),
           "max_abs_err": err,
           "max_rel_err": rel,
           "rel_limit": [conf_tol[same].min().item(),
                         conf_tol[same].max().item()],
           "worst_share_of_limit": (rel_t / conf_tol)[same].max().item(),
           "vs_f64": f64, "conf_median": conf.median().item(),
           "conf_ge_0.9": (conf >= 0.9).float().mean().item(),
           "near_ties": ties}
    if timed:
        library = lambda: torch.softmax(cap((h @ w.t()).float()),  # noqa
                                        -1).max(-1)
        times = alternate(torch, lambda: sref.select_streaming(
                              h, w, masked, softcap=softcap),
                          lambda: fused_select(h, w, masked, softcap=softcap),
                          library, iters=5)
        item = h.element_size()
        bms, by = bound_ms((T * d + V * d) * item + 4 * T + 8 * T,
                           2 * T * V * d, dtype)
        rec.update(kernel_ms=times["kernel"], plain_ms=times["plain"],
                   library_ms=times["library"], bound_ms=bms, bound_by=by,
                   kernel_device_ms=device_ms(
                       torch, lambda: fused_select(h, w, masked,
                                                   softcap=softcap), 5,
                       SELECT_KERNELS))
    log(json.dumps(rec))
    return rec


def grad_limit(torch, got, want, dtype):
    """Whether ``got`` is within the gradient limit of ``want``: fp32
    sides sum fp32 products in other orders, so 1e-5 of max|grad|; a bf16
    gradient is an fp32 sum rounded to bf16, so one bf16 ulp (2^-8
    relative, 2^-7 allowed) on top. Returns (ok, max abs error)."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    lim = 1e-5 * want.abs().max() + (0 if dtype == "float32"
                                     else 2 ** -7 * want.abs())
    return bool((err <= lim).all()), err.max().item()


def xent_f64(torch, h, w, y, chunk=8192):
    """The per-token loss in float64, vocab chunk by chunk: an oracle for
    fp32 sums (bf16 products are exact in float64)."""
    hd = h.double()
    m = torch.full((h.shape[0],), -torch.inf, dtype=torch.float64,
                   device=h.device)
    l, tgt = torch.zeros_like(m), torch.zeros_like(m)
    for j in range(0, w.shape[0], chunk):
        lo = hd @ w[j:j + chunk].double().t()
        here = (y >= j) & (y < j + lo.shape[1])
        at = lo.gather(1, (y - j).clamp(0, lo.shape[1] - 1)[:, None])[:, 0]
        tgt += torch.where(here, at, torch.zeros_like(at))
        m_new = torch.maximum(m, lo.amax(-1))
        l = l * torch.exp(m - m_new) + torch.exp(lo - m_new[:, None]).sum(-1)
        m = m_new
    return m + torch.log(l) - tgt


def check_xent(torch, dev, *, T, d, V, dtype, scale=0.02, timed=False,
               name="", config=None):
    """The fused cross-entropy forward and backward against their plain
    versions (both read the same inputs and accumulate in fp32), the
    backward twice bit for bit. ``scale`` 1 leaves W unscaled: logits of
    std ~30, a nearly one-hot softmax, and every other row's target on its
    argmax, so dh_acc cancels against g W_y (a bf16 pair of probabilities
    holds the gradient limit there, one bf16 rounding does not). ``config``:
    the ``tuning.KernelConfig`` the kernels launch with (None: the
    table's)."""
    import torch.nn.functional as F

    from repro_torch.kernels.xent import fused_xent
    from repro_torch.kernels.xent import ops as xops
    from repro_torch.kernels.xent import ref as xref
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(V % 1000 + T)
    h = torch.randn((T, d), generator=gen, device=dev).to(dt)
    w = (torch.randn((V, d), generator=gen, device=dev) * scale).to(dt)
    y = torch.randint(0, V, (T,), generator=gen, device=dev)
    y[:2] = torch.tensor([0, V - 1], device=dev)
    if scale == 1.0:
        y[3::2] = (h.float() @ w.float().t()).argmax(-1)[3::2]
    g = torch.rand((T,), generator=gen, device=dev)
    g[::5] = 0.0                               # rows with g = 0 still count
    loss, logz = xops._forward(h, w, y, config)
    dh, dw = xops._backward(h, w, y, logz, g, True, config)
    dh2, dw2 = xops._backward(h, w, y, logz, g, True, config)
    want, want_logz = xref.xent_streaming(h, w, y)
    want_dh, want_dw = xref.xent_backward(h, w, y, g, want_logz)
    oracle = xent_f64(torch, h, w, y)
    torch.cuda.synchronize()
    err = (loss - want).abs().max().item()
    err_f64 = (loss.double() - oracle).abs().max().item()
    plain_f64 = (want.double() - oracle).abs().max().item()
    tol = 1e-4
    # the loss against the float64 oracle, and against the plain version
    # wherever the plain version itself holds the limit to the oracle (its
    # fp32 logits miss by more with sharp logits of ~150 over d = 896)
    if not (err_f64 <= tol and (err <= tol or plain_f64 > tol)):
        raise AssertionError(f"xent {name}: loss max error {err} against "
                             f"the plain version (which is {plain_f64} off "
                             f"float64), {err_f64} against float64; "
                             f"limit {tol}")
    ok_h, err_h = grad_limit(torch, dh, want_dh, dtype)
    ok_w, err_w = grad_limit(torch, dw, want_dw, dtype)
    if not (ok_h and ok_w):
        raise AssertionError(f"xent {name}: dh error {err_h} ({ok_h}), dW "
                             f"error {err_w} ({ok_w}) beyond the limits")
    if not (torch.equal(dh, dh2) and torch.equal(dw, dw2)):
        raise AssertionError(f"xent {name}: two backward runs differ")
    rec = {"kernel": "xent", "case": name, "dtype": dtype,
           "shape": dict(T=T, d=d, V=V,
                         backward_chunk=xops._knobs(h, V, config).bwd_chunk),
           "max_abs_err": err, "tol": tol, "max_abs_err_vs_f64": err_f64,
           "plain_max_abs_err_vs_f64": plain_f64, "dh_max_abs_err": err_h,
           "dw_max_abs_err": err_w, "backward_bitwise_repeatable": True}
    if timed:
        item = h.element_size()
        hl, wl = h.clone().requires_grad_(), w.clone().requires_grad_()
        lib_loss = F.cross_entropy(hl @ wl.t(), y, reduction="none")
        fwd = alternate(torch, lambda: xref.xent_streaming(h, w, y),
                        lambda: xops._forward(h, w, y),
                        lambda: F.cross_entropy(h @ w.t(), y,
                                                reduction="none"), iters=5)
        bwd = alternate(
            torch, lambda: xref.xent_backward(h, w, y, g, logz),
            lambda: xops._backward(h, w, y, logz, g, True),
            lambda: torch.autograd.grad(lib_loss, (hl, wl), g,
                                        retain_graph=True), iters=3)
        io = (T * d + V * d) * item
        fb, fby = bound_ms(io + 4 * T * 3, 2 * T * V * d, dtype)
        bb, bby = bound_ms(2 * io + 4 * T * 3, 6 * T * V * d, dtype)
        # the bf16 route's own work: the logits again, then both products
        # on the pair e_hi + e_lo, 5 products of 2 T V d
        pair_b, _ = bound_ms(2 * io + 4 * T * 3, 10 * T * V * d, dtype)
        rec.update(
            forward=dict(kernel_ms=fwd["kernel"], plain_ms=fwd["plain"],
                         library_ms=fwd["library"], bound_ms=fb, bound_by=fby,
                         kernel_device_ms=device_ms(
                             torch, lambda: xops._forward(h, w, y), 5,
                             XENT_FWD_KERNELS)),
            backward=dict(kernel_ms=bwd["kernel"], plain_ms=bwd["plain"],
                          library_ms=bwd["library"], bound_ms=bb,
                          bound_by=bby, kernel_device_ms=device_ms(
                              torch, lambda: xops._backward(h, w, y, logz, g,
                                                            True), 3,
                              XENT_BWD_KERNELS)))
        if dtype == "bfloat16":
            rec["backward"]["pair_work_bound_ms"] = pair_b
        del lib_loss, hl, wl
    log(json.dumps(rec))
    return rec


def check_nan_residue(torch, dev, *, b, Bq, Kv, G, hd, S, lens, dtype,
                      page, name=""):
    """NaN in every cache row at or past each lane's length, and in every
    pool row that holds no key below it: both kernels' outputs equal
    their outputs over the finite residue, bit for bit."""
    from repro_torch.kernels.decode_attn import (
        decode_attention,
        paged_decode_attention,
    )
    dt = getattr(torch, dtype)
    g = torch.Generator(device=dev).manual_seed(len(name) + 3)
    rnd = lambda *s: torch.randn(s, generator=g, device=dev).to(dt)  # noqa
    q = rnd(b, Bq, Kv, G, hd)
    kc, vc = rnd(b, S, Kv, hd), rnd(b, S, Kv, hd)
    kb, vb = rnd(b, Bq, Kv, hd), rnd(b, Bq, Kv, hd)
    cl = torch.tensor(lens, dtype=torch.int32, device=dev)
    kw = dict(scale=hd ** -0.5)
    kp, vp, table = _paged_pool(torch, dev, kc, vc, cl, page, g)
    want = decode_attention(q, kc, vc, kb, vb, cl, **kw)
    want_paged = paged_decode_attention(q, kp, vp, kb, vb, table, cl, **kw)
    past = torch.arange(S, device=dev)[None, :] >= cl[:, None]
    kc[past], vc[past] = float("nan"), float("nan")
    held = torch.zeros(kp.shape[:2], dtype=torch.bool, device=dev)
    for lane, n in enumerate(lens):
        for j in range(-(-n // page)):
            held[int(table[lane, j]), :min(page, n - j * page)] = True
    kp[~held], vp[~held] = float("nan"), float("nan")
    got = decode_attention(q, kc, vc, kb, vb, cl, **kw)
    got_paged = paged_decode_attention(q, kp, vp, kb, vb, table, cl, **kw)
    torch.cuda.synchronize()
    ok = {"finite": bool(torch.isfinite(got).all()
                         and torch.isfinite(got_paged).all()),
          "dense_equal": torch.equal(got, want),
          "paged_equal": torch.equal(got_paged, want_paged)}
    if not all(ok.values()):
        raise AssertionError(f"NaN residue {name}: {ok}")
    rec = {"kernel": "decode_attention", "case": name, "dtype": dtype,
           "shape": dict(b=b, Bq=Bq, Kv=Kv, G=G, hd=hd, S=S, lens=lens,
                         page=page), "nan_residue": ok}
    log(json.dumps(rec))
    return rec


def arch_attention_cases(cfg):
    """The attention of phase 9's config ``cfg`` as its forward calls the
    kernels, one case per attention mixer kind of its layer period, in the
    period's order (none for an attention-free config): (slot kind, Kv, G,
    hd, scale / softcap / window keywords)."""
    from repro_torch.configs.base import ATTN, ATTN_LOCAL
    from repro_torch.models.layers import attn_scale
    out = []
    for kind in dict.fromkeys(slot[0] for slot in cfg.layer_period):
        if kind not in (ATTN, ATTN_LOCAL):
            continue
        kw = dict(scale=attn_scale(cfg), softcap=cfg.attn_logit_softcap,
                  window=cfg.sliding_window if kind == ATTN_LOCAL else None)
        out.append((kind, cfg.n_kv_heads, cfg.q_per_kv, cfg.head_dim, kw))
    return out


def attention_layers(cfg) -> int:
    """Layers with an attention mixer: one launch of an attention kernel
    each per forward."""
    from repro_torch.configs.base import ATTN, ATTN_LOCAL
    return cfg.n_periods * sum(m in (ATTN, ATTN_LOCAL)
                               for m, _ in cfg.layer_period)


def arch_key(kernel, config, Bq=32):
    """The kernels' summary key of ``kernel`` at phase 9's ``config``: the
    kernel and config, and for ``SHAPE_KEYED`` configs the checked shape
    (Kv, G, hd and the query rows a lane; d and V for select)."""
    if config not in SHAPE_KEYED:
        return f"{kernel} {config}"
    from repro_torch.configs import get_config
    cfg = get_config(config)
    if kernel == "fused_select":
        return f"{kernel} {config} d{cfg.d_model} V{cfg.vocab_size}"
    shape = f"Kv{cfg.n_kv_heads} G{cfg.q_per_kv} hd{cfg.head_dim}"
    if kernel == "block_attention":
        return f"{kernel} {config} {shape} L512"
    return f"{kernel} {config} {shape} Bq{Bq}"


def check_architectures(torch, dev, lens):
    """The kernels at phase 9's shapes, config by config (``ARCH_RUNS``):
    for each attention mixer kind, decode (dense and paged) at the main
    path's lengths and the prefill of 8 prompts of 512 tokens, bf16 and
    fp32, and decode at the split edges; for a ``SHAPE_KEYED`` config with
    attention also the AR step's decode (one query row a lane, as phase
    9's static ``ar`` run calls it); the fused select at 8 lanes of a
    32-token block over the config's unembedding (its final softcap too).
    The first mixer kind's bf16 cases and the select case are timed.
    Returns each config's bf16 records by summary key (``arch_key``); an
    entry whose config has two mixer kinds (gemma2-27b's local and global
    slots, of one shape) keeps the timed kind's times and the larger error
    of the two."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attn import ref as dref
    main = {}
    for config, _ in ARCH_RUNS:
        cfg = get_config(config)
        cases = arch_attention_cases(cfg)
        for i, (kind, kv, g, hd, extra) in enumerate(cases):
            name = f"{config} {kind}"
            for dtype in ("bfloat16", "float32"):
                main_case = dtype == "bfloat16"
                timed = main_case and i == 0
                recs = {
                    "decode_attention": check_decode(
                        torch, dev, b=8, Bq=32, Kv=kv, G=g, hd=hd, S=768,
                        lens=lens, dtype=dtype, timed=timed,
                        name=f"{name}/{dtype}", **extra),
                    "paged_decode_attention": check_paged(
                        torch, dev, b=8, Bq=32, Kv=kv, G=g, hd=hd, S=768,
                        lens=lens, dtype=dtype, timed=timed,
                        name=f"{name}/{dtype}", **extra),
                    "block_attention": check_block(
                        torch, dev, b=8 if main_case else 2, L=512, Kv=kv,
                        G=g, hd=hd, dtype=dtype, mode="block_causal",
                        prompt_len=512, block_size=32, timed=timed,
                        name=f"{name} prefill {dtype}", **extra)}
                if config in SHAPE_KEYED:
                    # phase 9's static ar run: caches of P + G rows
                    b_ar, p_ar, g_ar = AR_RUN
                    recs["decode_attention Bq1"] = check_decode(
                        torch, dev, b=b_ar, Bq=1, Kv=kv, G=g, hd=hd,
                        S=p_ar + g_ar, dtype=dtype, timed=timed,
                        lens=[p_ar + (j * 9) % g_ar for j in range(b_ar)],
                        name=f"{name} AR step Bq=1 {dtype}", **extra)
                for kernel, rec in recs.items():
                    key = (arch_key("decode_attention", config, Bq=1)
                           if kernel == "decode_attention Bq1"
                           else arch_key(kernel, config))
                    if timed:
                        main[key] = dict(rec, cases=[rec["case"]])
                    elif main_case:
                        main[key]["max_abs_err"] = max(
                            main[key]["max_abs_err"], rec["max_abs_err"])
                        main[key]["cases"].append(rec["case"])
            edge = dref.tiles_per_split(kv, 32 * g) * 64
            edges = dict(b=4, Bq=32, Kv=kv, G=g, hd=hd, S=edge + 40,
                         lens=[0, edge, edge + 1, edge + 40])
            for dtype in ("bfloat16", "float32"):
                check_decode(torch, dev, **edges, dtype=dtype, **extra,
                             name=f"{name} split edge {dtype}")
                check_paged(torch, dev, **edges, dtype=dtype, page=8,
                            **extra, name=f"{name} split edge {dtype}")
        if cases:
            _, kv, g, hd, _ = cases[0]
            check_block(torch, dev, b=2, L=130, Kv=kv, G=g, hd=hd,
                        dtype="bfloat16", mode="causal", window=40,
                        name=f"{config} causal window ragged")
        main[arch_key("fused_select", config)] = check_select(
            torch, dev, T=256, d=cfg.d_model, V=cfg.vocab_size,
            dtype="bfloat16", scale=0.02, softcap=cfg.final_logit_softcap,
            timed=True, name=f"{config} unembed")
    return main


def bf16_ulps(torch, a, b):
    """Per element, how many bf16 steps lie between a and b (both bf16)."""
    def ordered(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (ordered(a) - ordered(b)).abs()


def check_elementwise(torch, dev, *, arch, rows, timed=False):
    """The three fused elementwise passes against their plain versions at
    ``arch``'s widths and ``rows`` token rows (lanes of 32-row blocks at
    per-lane offsets, or 512-row prompts above 1,024 rows): the residual
    sum, QKV bias + RoPE and act(g) * u bit for bit, the norm within one
    bf16 ulp (its sum of squares runs in another order than PyTorch's
    mean). ``timed``: each pass's ms (CUDA events over back-to-back calls,
    and the profiler's device time), its plain version's, its bound at
    3.35 TB/s from the bytes it must move, and for the norm
    ``F.rms_norm``'s (the norm alone, which the port never calls). Returns
    a record per pass."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels.elementwise import (
        add_rmsnorm,
        gated_act,
        qkv_rope,
    )
    from repro_torch.kernels.elementwise import ref as eref
    cfg = get_config(arch)
    g = torch.Generator(device=dev).manual_seed(rows)
    L = 512 if rows > 1024 else 32
    b = rows // L
    d, hd, ff = cfg.d_model, cfg.head_dim, cfg.d_ff
    nq, nkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    bf = torch.bfloat16

    def r(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(bf)
    x, delta, w = r(b, L, d, scale=4.0), r(b, L, d), r(d, scale=0.1) + 1
    q, k, v = r(b, L, nq), r(b, L, nkv), r(b, L, nkv)
    bq, bk, bv = ((r(nq, scale=0.1), r(nkv, scale=0.1), r(nkv, scale=0.1))
                  if cfg.qkv_bias else (None, None, None))
    pos = (torch.arange(L, device=dev) if L == 512 else
           torch.randint(0, 737, (b, 1), device=dev, generator=g)
           + torch.arange(L, device=dev))
    gg, uu = r(b, L, ff, scale=3.0), r(b, L, ff)
    rope_kw = dict(head_dim=hd, theta=cfg.rope_theta)
    calls = {
        "add_rmsnorm": (lambda: add_rmsnorm(x, delta, w, cfg.norm_eps),
                        lambda: eref.add_rmsnorm(x, delta, w, cfg.norm_eps)),
        "qkv_rope": (lambda: qkv_rope(q, k, v, bq, bk, bv, pos, **rope_kw),
                     lambda: eref.qkv_rope(q, k, v, bq, bk, bv, pos,
                                           **rope_kw)),
        "gated_act": (lambda: gated_act(gg, uu, cfg.activation),
                      lambda: eref.gated_act(gg, uu, cfg.activation))}
    item = 2
    io = 2 if bv is not None else 0
    n_bytes = {"add_rmsnorm": 4 * rows * d * item + d * item,
               "qkv_rope": 2 * rows * (nq + nkv) * item + io * rows * nkv
               * item + (nq + 2 * nkv) * item * (bq is not None)
               + rows * 8,
               "gated_act": 3 * rows * ff * item}
    recs = {}
    with torch.no_grad():
        for name, (kernel, plain) in calls.items():
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            ulps = max(bf16_ulps(torch, a, c).max().item()
                       for a, c in zip(got, want))
            exact = [torch.equal(a, c) for a, c in zip(got, want)]
            # the norm's h may sit one bf16 ulp off; every other output is
            # the plain path's bit for bit
            ok = (exact[0] and ulps <= 1 if name == "add_rmsnorm"
                  else all(exact))
            if not ok:
                raise AssertionError(f"{name} {arch} rows {rows}: "
                                     f"{ulps} bf16 ulps, equal {exact}")
            rec = {"kernel": name, "case": f"{arch} rows {rows}",
                   "max_abs_err": max((a.float() - c.float()).abs().max()
                                      .item() for a, c in zip(got, want)),
                   "max_bf16_ulps": ulps, "bit_equal": exact}
            if timed:
                library = None
                if name == "add_rmsnorm":
                    s_ = x + delta
                    library = lambda: F.rms_norm(  # noqa: E731
                        s_, (d,), w, cfg.norm_eps)
                times = alternate(torch, plain, kernel, library, iters=20)
                bms, by = bound_ms(n_bytes[name], 0, "bfloat16")
                rec.update(kernel_ms=times["kernel"], plain_ms=times["plain"],
                           library_ms=times.get("library"), bound_ms=bms,
                           bound_by=by, bytes=n_bytes[name],
                           kernel_device_ms=device_ms(
                               torch, kernel, 20, ELEMENTWISE_KERNELS[name]),
                           plain_device_ms=device_ms(torch, plain, 20, [""]),
                           library_device_ms=library and device_ms(
                               torch, library, 20, [""]))
            log(json.dumps(rec))
            recs[name] = rec
    return recs


def check_qk_norm(torch, dev, *, rows, timed=False):
    """qkv_rope's QK-norm instance against its plain version at
    sdar-30b-a3b's widths (32 q and 4 kv heads of 128, no bias) and
    ``rows`` token rows in lanes of 32 at per-lane offsets: v bit for bit,
    q and k within ``QK_NORM_ULPS`` bf16 ulps of their largest value (the
    head's sum of squares runs in another order than PyTorch's mean, so a
    normed value may sit one ulp off before its rotation). ``timed``: its
    ms beside the plain
    version's and its bytes' bound. Returns the record."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.elementwise import qkv_rope
    from repro_torch.kernels.elementwise import ref as eref
    cfg = get_config("sdar-30b-a3b")
    g = torch.Generator(device=dev).manual_seed(rows)
    b, L, hd = rows // 32, 32, cfg.head_dim
    nq, nkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    bf = torch.bfloat16

    def r(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(bf)
    q, k, v = r(b, L, nq, scale=3.0), r(b, L, nkv, scale=3.0), r(b, L, nkv)
    qn, kn = r(hd, scale=0.1) + 1, r(hd, scale=0.1) + 1
    pos = (torch.randint(0, 737, (b, 1), device=dev, generator=g)
           + torch.arange(L, device=dev))
    kw = dict(head_dim=hd, theta=cfg.rope_theta, q_norm=qn, k_norm=kn,
              eps=cfg.norm_eps)

    def kernel():
        return qkv_rope(q, k, v, None, None, None, pos, **kw)

    def plain():
        return eref.qkv_rope(q, k, v, None, None, None, pos, **kw)
    with torch.no_grad():
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        ulps = [bf16_ulps(torch, a, c).max().item()
                for a, c in zip(got, want)]
        off = [(a != c).float().mean().item() for a, c in zip(got, want)]
        # one bf16 ulp of the largest |value|: 2^(floor(log2 max) - 7)
        top = [2.0 ** (math.floor(math.log2(c.float().abs().max().item()))
                       - 7) for c in want[:2]]
        errs = [(a.float() - c.float()).abs().max().item()
                for a, c in zip(got, want)]
        if (any(e > QK_NORM_ULPS * u for e, u in zip(errs, top))
                or not torch.equal(got[2], want[2])):
            raise AssertionError(f"qkv_rope QK-norm rows {rows}: q, k, v "
                                 f"off by {errs} (ulps of the largest "
                                 f"{top}), {ulps} bf16 ulps")
        rec = {"kernel": "qkv_rope QK-norm", "case": f"sdar-30b-a3b rows "
               f"{rows}", "max_bf16_ulps": ulps, "share_not_equal": off,
               "max_abs_err": max(errs), "ulp_of_largest": top}
        if timed:
            n_bytes = 2 * rows * (nq + nkv) * 2 + 2 * hd * 2 + rows * 8
            before = qkv_rope.launches
            times = alternate(torch, plain, kernel, None, iters=20)
            bms, by = bound_ms(n_bytes, 0, "bfloat16")
            rec.update(kernel_ms=times["kernel"], plain_ms=times["plain"],
                       bound_ms=bms, bound_by=by, bytes=n_bytes,
                       launches=qkv_rope.launches - before,
                       kernel_device_ms=device_ms(torch, kernel, 20,
                                                  ["qkv_rope_kernel"]))
    log(json.dumps(rec))
    return rec


def moe_inputs(torch, dev, *, T, E, k, d, f, seed=0):
    """Routed inputs of one grouped MoE layer: x (T, d) bf16 and the
    experts (std 1/sqrt(fan in)), each token's gates and top-k ids from a
    random router's fp32 softmax (``models/moe.py::route``)."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models.moe import route
    g = torch.Generator(device=dev).manual_seed(seed)
    bf = torch.bfloat16

    def r(*shape, scale):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(bf)
    x = r(T, d, scale=1.0)
    w = {"router": r(d, E, scale=d ** -0.5),
         "wi_gate": r(E, d, f, scale=d ** -0.5),
         "wi_up": r(E, d, f, scale=d ** -0.5),
         "wo": r(E, f, d, scale=f ** -0.5)}
    cfg = ModelConfig(name="moe", family="moe", n_layers=1, d_model=d,
                      n_heads=1, n_kv_heads=1, d_ff=f, vocab_size=8,
                      n_experts=E, experts_per_token=k, moe_d_ff=f,
                      layer_period=(("attn", "moe"),),
                      moe_dispatch="grouped")
    _, gates, ids = route(w, x, cfg)
    return x, gates, ids, w


def check_moe(torch, dev, *, T, E=128, k=8, d=2048, f=768, timed=False):
    """The grouped MoE's five kernels against the plain version
    (``kernels/moe/ref.py``, the same bf16 rounding points, fp32 sums on
    the card) at T tokens of top-k over E experts of d x f: the alignment's
    counts and tiles equal the plain layout's and every pair's row lies in
    its expert's group, once; the output within ``MOE_REL`` of max|y|.
    ``timed``: the five kernels' ms (CUDA
    events) and device time per kernel, the plain version's ms, and the
    bound: every expert hit read once, the pairs' rows in and out once,
    2 * 3 * pairs * d * f operations. Returns the record."""
    from repro_torch.kernels.moe import (
        grouped_experts,
        moe_align,
        moe_gate_up,
    )
    from repro_torch.kernels.moe import ref as mref
    x, gates, ids, w = moe_inputs(torch, dev, T=T, E=E, k=k, d=d, f=f,
                                  seed=T)
    P = T * k
    with torch.no_grad():
        row_of, tile_expert, tile_rows, n_tiles = moe_align(
            ids.reshape(-1).contiguous(), E)
        p_row, p_te, p_tr, counts = mref.align(ids, E)
        n = int(n_tiles.item())
        rows_ok = (torch.equal(tile_expert[:n], p_te.int())
                   and torch.equal(tile_rows[:n], p_tr.int())
                   and n == len(p_te)
                   and torch.equal(tile_expert[row_of.long() // mref.BM],
                                   ids.reshape(-1).int())
                   and len(torch.unique(row_of)) == P)
        if not rows_ok:
            raise AssertionError(f"moe_align T {T}: the layout differs from "
                                 "the plain one")

        def kernel():
            return grouped_experts(x, gates, ids, w["wi_gate"], w["wi_up"],
                                   w["wo"])

        def plain():
            return mref.grouped_experts(x, gates, ids, w["wi_gate"],
                                        w["wi_up"], w["wo"])
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        scale = want.float().abs().max().item()
        abs_err = (got.float() - want.float()).abs().max().item()
        err = abs_err / scale
        rec = {"kernel": "grouped_experts", "case": f"T {T} E {E} k {k} "
               f"d {d} f {f}", "pairs": P, "rows_padded": n * mref.BM,
               "max_abs_err": abs_err, "max_err_over_max_y": err,
               "max_bf16_ulps": bf16_ulps(torch, got, want).max().item(),
               "share_not_equal": (got != want).float().mean().item()}
        if not err <= MOE_REL:
            raise AssertionError(f"grouped MoE T {T}: {rec}")
        if timed:
            hit = int((counts > 0).sum())
            n_bytes = 2 * (3 * hit * d * f + 2 * T * d)
            n_ops = 2 * 3 * P * d * f
            before = moe_gate_up.launches
            times = alternate(torch, plain, kernel, None, iters=5)
            bms, by = bound_ms(n_bytes, n_ops, "bfloat16")
            per = {name: device_ms(torch, kernel, 5, [name + "("])
                   for name in MOE_KERNELS}
            dev_ms = sum(v for v in per.values() if v)
            rec.update(kernel_ms=times["kernel"], plain_ms=times["plain"],
                       bound_ms=bms, bound_by=by, bytes=n_bytes, ops=n_ops,
                       launches=moe_gate_up.launches - before,
                       device_ms=per, roofline_pct=100 * bms / dev_ms)
    log(json.dumps(rec))
    return rec


def phase_kernels(torch, dev):
    from repro_torch.kernels.decode_attn import ref as dref
    lens8 = [0, 512, 536, 577, 608, 640, 700, 736]
    main = {}
    for name, kv, g, hd, dtypes in (
            ("qwen2-0.5b", 2, 7, 64, ("bfloat16", "float32")),
            ("dream-7b", 4, 7, 128, ("bfloat16", "float32")),
            ("llada-8b", 32, 1, 128, ("bfloat16",))):
        for dtype in dtypes:
            rec = check_decode(torch, dev, b=8, Bq=32, Kv=kv, G=g, hd=hd,
                               S=768, lens=lens8, dtype=dtype, timed=True,
                               name=f"{name}/{dtype}")
            prec = check_paged(torch, dev, b=8, Bq=32, Kv=kv, G=g, hd=hd,
                               S=768, lens=lens8, dtype=dtype, timed=True,
                               name=f"{name}/{dtype}")
            if name == "qwen2-0.5b" and dtype == "bfloat16":
                main["decode_attention"] = rec
                main["paged_decode_attention"] = prec
    # the bf16 route's split edges: cache_len 0, on the first split edge,
    # one past it, and S, with S not a multiple of 64
    for name, kv, g, hd in (("qwen2-0.5b", 2, 7, 64), ("dream-7b", 4, 7, 128),
                            ("llada-8b", 32, 1, 128)):
        edge = dref.tiles_per_split(kv, 32 * g) * 64
        S = edge + 40
        edges = dict(b=4, Bq=32, Kv=kv, G=g, hd=hd, S=S,
                     lens=[0, edge, edge + 1, S])
        for dtype in ("bfloat16", "float32"):
            check_decode(torch, dev, **edges, dtype=dtype,
                         name=f"{name} split edge {dtype}")
            check_paged(torch, dev, **edges, dtype=dtype, page=8,
                        name=f"{name} split edge {dtype}")
            check_nan_residue(torch, dev, **edges, dtype=dtype, page=8,
                              name=f"{name} NaN residue {dtype}")
    # the AR step (phase 7): one query row per lane (Bq G = 7 folded rows of
    # a 64-row tile), caches of 576 rows filled to 512..575
    lens_ar = [512, 513, 527, 544, 559, 560, 574, 575]
    for name, kv, g, hd, dtypes in (
            ("qwen2-0.5b", 2, 7, 64, ("bfloat16", "float32")),
            ("dream-7b", 4, 7, 128, ("bfloat16", "float32")),
            ("llada-8b", 32, 1, 128, ("bfloat16",))):
        for dtype in dtypes:
            check_decode(torch, dev, b=8, Bq=1, Kv=kv, G=g, hd=hd, S=576,
                         lens=lens_ar, dtype=dtype,
                         timed=dtype == "bfloat16",
                         name=f"{name} AR step Bq=1 {dtype}")
    small = dict(b=2, Bq=8, Kv=2, G=2, hd=64, S=64, lens=[5, 40])
    for check in (check_decode, check_paged):
        check(torch, dev, **small, dtype="float32", softcap=5.0,
              name="softcap")
        check(torch, dev, **small, dtype="float32", window=6, name="window")
        check(torch, dev, **small, dtype="bfloat16", softcap=5.0, window=6,
              name="softcap+window")
    check_paged(torch, dev, **dict(small, S=60), dtype="float32", page=5,
                window=9, name="page 5")
    # the prefill of every admission: 8 lanes of a 512-token prompt, all
    # of it block -1, so every key is visible
    prefill = dict(b=8, L=512, G=7, dtype="bfloat16", mode="block_causal",
                   prompt_len=512, block_size=32, timed=True)
    main["block_attention"] = check_block(torch, dev, Kv=2, hd=64, **prefill,
                                          name="qwen2-0.5b prefill")
    check_block(torch, dev, Kv=4, hd=128, **prefill, name="dream-7b prefill")
    small = dict(b=2, Kv=2, G=3, hd=64, dtype="float32")
    check_block(torch, dev, L=100, mode="causal", **small, name="causal")
    check_block(torch, dev, L=77, mode="bidirectional", **small,
                name="bidirectional ragged")
    check_block(torch, dev, L=90, mode="block_causal", prompt_len=40,
                block_size=16, **small, name="block_causal P<L ragged")
    check_block(torch, dev, L=96, mode="block_causal", prompt_len=32,
                block_size=16, window=20, **small, name="window")
    check_block(torch, dev, L=64, mode="causal", softcap=3.0, window=9,
                **small, name="causal softcap+window")
    check_block(torch, dev, b=2, L=70, Kv=2, G=7, hd=128, dtype="bfloat16",
                mode="bidirectional", softcap=5.0, name="bf16 softcap")
    # the trajectory collector's forwards (phase 5): 4 lanes of a 384-token
    # canvas (P=128 + G=256), bidirectional
    main["block_attention collector"] = check_block(
        torch, dev, b=4, L=384, Kv=2, G=7, hd=64, dtype="bfloat16",
        mode="bidirectional", prompt_len=128, block_size=32, timed=True,
        name="qwen2-0.5b collector")
    # phase 7's full-sequence forwards: fast_dllm's canvas every iteration
    # and the approx refreshes (8 lanes, P=512 + G=64, bidirectional), ar's
    # prompt prefill (8 lanes, 512 tokens, causal)
    check_block(torch, dev, b=8, L=576, Kv=2, G=7, hd=64, dtype="bfloat16",
                mode="bidirectional", prompt_len=512, block_size=32,
                timed=True, name="qwen2-0.5b canvas L=576")
    check_block(torch, dev, b=8, L=512, Kv=2, G=7, hd=64, dtype="bfloat16",
                mode="causal", timed=True, name="qwen2-0.5b causal prefill")
    for mode, L in (("bidirectional", 576), ("causal", 512)):
        check_block(torch, dev, b=2, L=L, Kv=2, G=7, hd=64, dtype="float32",
                    mode=mode, name=f"{mode} L={L} float32")
    main.update(check_architectures(torch, dev, lens8))
    main.update(check_extras_kernels(torch, dev))
    main["fused_select"] = check_select(
        torch, dev, T=256, d=896, V=151_936, dtype="bfloat16", scale=0.02,
        timed=True, name="qwen2-0.5b tied")
    check_select(torch, dev, T=256, d=3584, V=152_064, dtype="bfloat16",
                 scale=0.02, timed=True, name="dream-7b untied")
    check_select(torch, dev, T=256, d=896, V=151_936, dtype="float32",
                 scale=0.02, name="qwen2-0.5b fp32")
    for dtype in ("bfloat16", "float32"):
        check_select(torch, dev, T=256, d=896, V=151_936, dtype=dtype,
                     scale=1.0, name=f"qwen2-0.5b sharp {dtype}")
    # the collector's selection: 4 lanes x a 32-token block
    check_select(torch, dev, T=128, d=896, V=151_936, dtype="bfloat16",
                 scale=0.02, name="qwen2-0.5b collector")
    # the training path's cross-entropy: b=4 x G=256 rows, qwen2-0.5b head
    for dtype in ("bfloat16", "float32"):
        rec = check_xent(torch, dev, T=1024, d=896, V=151_936, dtype=dtype,
                         timed=True, name=f"qwen2-0.5b {dtype}")
        if dtype == "bfloat16":
            main["xent"] = rec
    check_xent(torch, dev, T=1024, d=896, V=151_936, dtype="bfloat16",
               scale=1.0, name="qwen2-0.5b sharp bfloat16")
    for dtype in ("float32", "bfloat16"):
        check_xent(torch, dev, T=300, d=256, V=50_021, dtype=dtype,
                   name=f"ragged V {dtype}")
    check_xent(torch, dev, T=300, d=256, V=50_021, dtype="bfloat16",
               scale=1.0, name="ragged V sharp bfloat16")
    # the forward's elementwise passes: timed at the main path's shapes
    # (dream-7b: one lane's 32 rows, 32 lanes' 1,024, an admission's
    # 16,384), checked at the other configs' widths
    for rows in (32, 1024, 16384):
        recs = check_elementwise(torch, dev, arch="dream-7b", rows=rows,
                                 timed=True)
        if rows == 1024:
            main.update(recs)
    for arch in ("llada-8b", "qwen2-0.5b", "gemma-7b"):
        for rows in (32, 1024):
            check_elementwise(torch, dev, arch=arch, rows=rows)
    # sdar-30b-a3b: the QK-norm instance of qkv_rope, and the grouped MoE
    # at 32, 64 and 128 lanes' blocks and 64 and 128 lanes' admissions
    # (32,768 and 65,536 tokens)
    main["qkv_rope_qk_norm"] = check_qk_norm(torch, dev, rows=1024,
                                             timed=True)
    check_qk_norm(torch, dev, rows=4096)
    check_moe(torch, dev, T=64, E=4, k=2, d=256, f=256)
    for T in (1024, 2048, 4096, 32768, 65536):
        rec = check_moe(torch, dev, T=T, timed=True)
        if T == 1024:
            main["grouped_moe"] = rec
    return main


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------
def _random_params(torch, cfg, dev, dtype):
    from repro_torch.bridge import init_params
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev,
                         dtype)
    # a zero mask-token row: as in a trained model, the mask token is never
    # a candidate, so every returned span holds real tokens
    params["embed"]["tok"][cfg.mask_token_id] = 0
    if "head" in params["embed"]:                 # an untied head, (V, d)
        params["embed"]["head"][cfg.mask_token_id] = 0
    return params


def kernel_counters():
    """Each kernel's (wrapper, counter attribute)."""
    from repro_torch.kernels.block_attn import flash_block_attention
    from repro_torch.kernels.decode_attn import (
        decode_attention,
        paged_decode_attention,
    )
    from repro_torch.kernels.elementwise import (
        add_rmsnorm,
        gated_act,
        qkv_rope,
    )
    from repro_torch.kernels.moe import (
        moe_align,
        moe_combine,
        moe_down,
        moe_gate_up,
        moe_gather,
    )
    from repro_torch.kernels.select import fused_select
    from repro_torch.kernels.xent import fused_xent
    return {"decode_attention": (decode_attention, "launches"),
            "fused_select": (fused_select, "launches"),
            "paged_decode_attention": (paged_decode_attention, "launches"),
            "block_attention": (flash_block_attention, "launches"),
            "xent_forward": (fused_xent, "launches"),
            "xent_backward": (fused_xent, "backward_launches"),
            "add_rmsnorm": (add_rmsnorm, "launches"),
            "qkv_rope": (qkv_rope, "launches"),
            "gated_act": (gated_act, "launches"),
            **{name: (fn, "launches") for name, fn in zip(
                MOE_KERNELS, (moe_align, moe_gather, moe_gate_up, moe_down,
                              moe_combine))}}


def zero_counts():
    for fn, attr in kernel_counters().values():
        setattr(fn, attr, 0)


def read_counts():
    return {name: getattr(fn, attr)
            for name, (fn, attr) in kernel_counters().items()}


def serve_counted(torch, dev, eng, reqs):
    """``eng.generate(reqs)`` with every kernel's launch count set to 0 just
    before and read just after. Returns (outputs by id, wall s, launches)."""
    zero_counts()
    t0 = time.perf_counter()
    outs = eng.generate(reqs)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = read_counts()
    return {o.id: o for o in outs}, wall, launches


def elementwise_launches(cfg, forwards: int) -> dict:
    """The fused elementwise passes' launches in ``forwards`` forwards of
    ``cfg`` with grad off: at bf16, two add + norms a slot and the final
    norm (rmsnorm), a QKV bias + RoPE per attention slot (RoPE), an
    act(g) * u per gated MLP slot (silu, tanh gelu), each of the grouped
    MoE's five kernels once per MOE slot of a "grouped" config (a forward
    of at most ``kernels.moe.ops.MAX_TOKENS`` tokens); none otherwise."""
    from repro_torch.configs.base import MLP, MOE
    fused = cfg.dtype == "bfloat16"
    n_slots = cfg.n_periods * len(cfg.layer_period)
    n_mlp = cfg.n_periods * sum(f == MLP for _, f in cfg.layer_period)
    n_moe = (cfg.n_periods * sum(f == MOE for _, f in cfg.layer_period)
             if fused and cfg.moe_dispatch == "grouped" else 0)
    return {"add_rmsnorm": forwards * (2 * n_slots + 1)
            if fused and cfg.norm_type == "rmsnorm" else 0,
            "qkv_rope": forwards * attention_layers(cfg)
            if fused and cfg.pos_embed == "rope" else 0,
            "gated_act": forwards * n_mlp
            if fused and cfg.activation in ("silu", "gelu") else 0,
            **{name: forwards * n_moe for name in MOE_KERNELS}}


def check_launches(cfg, calls, launches, layout):
    """Each kernel launched exactly as often as the engine's call accounting
    says: select once per refinement iteration, block attention once per
    attention layer and admission, the layout's decode attention once per
    attention layer and cached forward, the other layout's never, the
    elementwise passes as ``elementwise_launches`` says for every
    forward."""
    n_attn = attention_layers(cfg)
    cached = n_attn * (calls["refine"] + calls["commit"])
    want = {"decode_attention": cached if layout == "dense" else 0,
            "fused_select": calls["refine"],
            "paged_decode_attention": cached if layout == "paged" else 0,
            "block_attention": n_attn * calls["admit"],
            "xent_forward": 0, "xent_backward": 0,
            **elementwise_launches(cfg, calls["admit"] + calls["refine"]
                                   + calls["commit"])}
    if launches != want:
        raise AssertionError(f"{layout}: launches {launches} != the call "
                             f"accounting {want} ({calls})")


def check_outputs(cfg, outs, caps, B):
    """Every request completed; no mask token left in a block it decoded
    (every block up to its cap, or, stopped by EOS, up to the block that
    holds it: the engine decodes no block past that); steps and generation
    length within their bounds."""
    if sorted(outs) != sorted(caps):
        raise AssertionError("not every request completed")
    for rid, o in outs.items():
        cap = caps[rid]
        n_blocks = -(-cap // B)
        decoded = (o.gen_length // B + 1 if o.finish_reason == "stop"
                   else n_blocks)
        if np.any(o.tokens[:decoded * B] == cfg.mask_token_id):
            raise AssertionError(f"request {rid}: mask token left")
        if not (1 <= o.steps <= n_blocks * B and o.gen_length <= cap):
            raise AssertionError(f"request {rid}: steps {o.steps} / "
                                 f"gen_length {o.gen_length} out of bounds")


def phase_serving(torch, dev):
    from repro_torch.configs import ServeConfig, get_config
    from repro_torch.serving import ContinuousEngine, Request

    cfg = get_config("qwen2-0.5b")
    P, B, G = 512, 32, 256
    params = _random_params(torch, cfg, dev, "bfloat16")
    serve = ServeConfig(max_batch=8, block_size=B, gen_length=G,
                        conf_threshold=0.9, scheduler="continuous",
                        fused_select=True)
    eng = ContinuousEngine(params, cfg, serve, prompt_len=P, device=dev)
    eng.warmup()
    rng = np.random.default_rng(0)
    caps = [256, 64, 128, 32, 96, 256, 32, 160, 64, 224, 128, 32]
    prompts = rng.integers(0, cfg.mask_token_id, (len(caps), P))
    reqs = [Request(prompt=p, id=i, max_tokens=c)
            for i, (p, c) in enumerate(zip(prompts, caps))]
    torch.cuda.reset_peak_memory_stats(dev)
    outs, wall, launches = serve_counted(torch, dev, eng, reqs)
    calls = eng.call_counts()
    check_outputs(cfg, outs, dict(enumerate(caps)), B)
    check_launches(cfg, calls, launches, "dense")
    tokens = sum(o.gen_length for o in outs.values())
    if not eng._graphs:
        raise AssertionError("serving: the engine did not capture its graphs")
    rec = {"phase": "serving", "config": "qwen2-0.5b", "dtype": "bfloat16",
           "layout": "dense", "graphs": True, "requests": len(outs),
           "max_batch": 8,
           "block": B, "gen": G, "prompt_len": P, "tau": 0.9,
           "tokens": tokens, "wall_s": wall, "tps": tokens / wall,
           "mean_latency_s": float(np.mean([o.latency_s
                                            for o in outs.values()])),
           "mean_steps": float(np.mean([o.steps for o in outs.values()])),
           "calls": calls, "launches": launches,
           "concurrency": eng.concurrency_stats(),
           "max_memory_allocated_bytes":
               torch.cuda.max_memory_allocated(dev)}
    log(json.dumps(rec))
    log(json.dumps(profile_block(torch, dev, eng, prompts[:8], B)))
    return {"cfg": cfg, "params": params, "serve": serve, "P": P, "B": B,
            "caps": caps, "prompts": prompts, "outs": outs,
            "launches": launches,
            "rec": {k: rec[k] for k in ("tokens", "wall_s", "tps",
                                        "mean_latency_s")}}


def phase_paged(torch, dev, ctx):
    """The dense phase's trace on the paged layout: a dense-equivalent pool
    (8 x 24 pages), then a tight one (40 pages, the first 8 requests) that
    stalls and preempts. The layouts run bit-identical arithmetic per lane
    (the paged kernel equals the dense one bit for bit, and a lane's rows
    never meet another lane's), so tokens must equal the dense run's
    exactly."""
    import dataclasses

    from repro_torch.serving import ContinuousEngine, Request
    cfg, P, B = ctx["cfg"], ctx["P"], ctx["B"]
    caps, prompts = ctx["caps"], ctx["prompts"]
    launches = {}
    for case, pool, n_req in (("dense-equivalent", None, len(caps)),
                              ("tight", 40, 8)):
        serve = dataclasses.replace(ctx["serve"], cache_layout="paged",
                                    page_pool_pages=pool)
        eng = ContinuousEngine(ctx["params"], cfg, serve, prompt_len=P,
                               device=dev)
        eng.warmup()
        reqs = [Request(prompt=prompts[i], id=i, max_tokens=caps[i])
                for i in range(n_req)]
        outs, wall, counts = serve_counted(torch, dev, eng, reqs)
        calls = eng.call_counts()
        if not eng._graphs:
            raise AssertionError(f"paged {case}: no graphs captured")
        check_outputs(cfg, outs, {i: caps[i] for i in range(n_req)}, B)
        check_launches(cfg, calls, counts, "paged")
        for rid, o in outs.items():
            want = ctx["outs"][rid]
            if not (np.array_equal(o.tokens, want.tokens)
                    and o.steps == want.steps):
                diff = np.flatnonzero(o.tokens != want.tokens)
                raise AssertionError(
                    f"paged {case}: request {rid} differs from the dense "
                    f"layout (steps {o.steps} vs {want.steps}, first token "
                    f"positions {diff[:5].tolist()})")
        stats = eng.page_pool_stats()
        accounting = eng.page_accounting()
        if accounting != (eng.n_pages, eng.n_pages):
            raise AssertionError(f"paged {case}: pool not fully free at the "
                                 f"end: {accounting} of {eng.n_pages}")
        if pool is not None and not (stats["stall_rounds"] >= 1
                                     and stats["preemptions"] >= 1):
            raise AssertionError(f"paged {case}: no stall or no preemption "
                                 f"{stats}")
        tokens = sum(o.gen_length for o in outs.values())
        log(json.dumps({
            "phase": "paged serving", "case": case, "config": "qwen2-0.5b",
            "dtype": "bfloat16", "requests": len(outs), "tokens": tokens,
            "wall_s": wall, "tps": tokens / wall, "calls": calls,
            "launches": counts, "page_pool_stats": stats,
            "concurrency": eng.concurrency_stats(),
            "page_accounting": accounting, "tokens_equal_dense": True}))
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
    return launches


def phase_graph_vs_eager(torch, dev, ctx):
    """Phase 3's trace on the dense layout and phase 3b's tight-pool case,
    each through an eager engine (``graphs=False``) and a graph engine, in
    turns: eager, graph, graph, eager. Every run equals the first eager
    run in tokens, steps, gen_length, finish_reason, call counts, page
    statistics and launches, and its launches equal the call accounting;
    then a profiled block of each engine."""
    import dataclasses

    from repro_torch.serving import ContinuousEngine, Request
    cfg, P, B = ctx["cfg"], ctx["P"], ctx["B"]
    caps, prompts = ctx["caps"], ctx["prompts"]
    tight = dataclasses.replace(ctx["serve"], cache_layout="paged",
                                page_pool_pages=40)
    for case, serve, n_req in (("dense", ctx["serve"], len(caps)),
                               ("paged tight", tight, 8)):
        layout = serve.cache_layout
        engines = {name: ContinuousEngine(ctx["params"], cfg, serve,
                                          prompt_len=P, device=dev,
                                          graphs=graphs)
                   for name, graphs in (("eager", False), ("graph", None))}
        for eng in engines.values():
            eng.warmup()
        if not engines["graph"]._graphs or engines["eager"]._graphs:
            raise AssertionError(f"{case}: graphs on the wrong engine")
        reqs = [Request(prompt=prompts[i], id=i, max_tokens=caps[i])
                for i in range(n_req)]
        runs, ref = {"eager": [], "graph": []}, None
        for name in ("eager", "graph", "graph", "eager"):
            eng = engines[name]
            outs, wall, counts = serve_counted(torch, dev, eng, reqs)
            calls = eng.call_counts()
            check_outputs(cfg, outs, {i: caps[i] for i in range(n_req)}, B)
            check_launches(cfg, calls, counts, layout)
            got = ({rid: (o.tokens.tolist(), o.steps, o.gen_length,
                          o.finish_reason) for rid, o in outs.items()},
                   calls, eng.page_pool_stats(), counts)
            ref = ref or got
            for what, a, b in zip(("outputs", "calls", "page stats",
                                   "launches"), got, ref):
                if a != b:
                    raise AssertionError(f"{case}: {name} run's {what} "
                                         "differ from the eager run's")
            tokens = sum(o.gen_length for o in outs.values())
            runs[name].append({
                "wall_s": wall, "tps": tokens / wall,
                "mean_latency_s": float(np.mean([o.latency_s
                                                 for o in outs.values()]))})
        stats = ref[2]
        if layout == "paged" and not (stats["stall_rounds"] >= 1
                                      and stats["preemptions"] >= 1):
            raise AssertionError(f"{case}: no stall or no preemption {stats}")
        # the profiled block: as many one-block requests as one admission
        # round takes (8 lanes; the tight pool admits 2)
        lanes = (engines["graph"].n_pages // engines["graph"]._admit_pages
                 if layout == "paged" else 8)
        profiles = {}
        for name, eng in engines.items():
            prof = profile_block(torch, dev, eng, prompts[:lanes], B)
            profiles[name] = {k: prof[k] for k in (
                "requests", "wall_ms", "device_busy_ms", "idle_share",
                "unprofiled_wall_ms", "idle_share_of_unprofiled_wall",
                "trace_read_s", "device_ms_by_group")}
        log(json.dumps({"phase": "graph vs eager", "case": case,
                        "config": "qwen2-0.5b", "dtype": "bfloat16",
                        "requests": n_req, "calls": ref[1],
                        "page_pool_stats": stats, "launches": ref[3],
                        "equal": True, "runs": runs,
                        "profiled_block": profiles}))


def device_groups(prof, recurrent=False):
    """Device ms by kernel group from a profiler trace, and by kernel name
    as (ms, count). ``recurrent`` (phase 9) also takes the recurrences'
    fused multiply-adds (``RECURRENCE_MARKS``) and the MoE dispatch's
    kernels (``MOE_MARKS``) out of "other" into groups of their own."""
    by_kernel = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if us:
            by_kernel[ev.key] = (us / 1e3, ev.count)
    groups = {"decode_attention": 0.0, "block_attention": 0.0,
              "fused_select": 0.0, "xent": 0.0, "matmul": 0.0, "other": 0.0}
    for key, (ms, _) in by_kernel.items():
        if "decode_attn" in key or "decode_merge" in key:
            groups["decode_attention"] += ms
        elif "block_attn" in key:
            groups["block_attention"] += ms
        elif "select_" in key:
            groups["fused_select"] += ms
        elif "xent_" in key:
            groups["xent"] += ms
        elif any(s in key.lower() for s in ("gemm", "cutlass", "xmma",
                                            "nvjet", "sm90")):
            groups["matmul"] += ms
        elif recurrent and any(m in key for m in RECURRENCE_MARKS):
            groups["recurrence"] = groups.get("recurrence", 0.0) + ms
        elif recurrent and any(m in key for m in MOE_MARKS):
            groups["moe_dispatch"] = groups.get("moe_dispatch", 0.0) + ms
        else:
            groups["other"] += ms
    return groups, by_kernel


def elementwise_kinds(by_kernel):
    """Device ms and launches of the elementwise adds, fills and copies in
    a trace (by kernel name), all dtypes and bf16 alone: the kernels a
    period-stacked gradient multiplies."""
    kinds = {"add": ("CUDAFunctor_add", "AddFunctor"),
             "fill": ("FillFunctor",), "copy": ("copy_kernel",),
             "bf16_add": ("CUDAFunctor_add<c10::BFloat16>",),
             "bf16_fill": ("FillFunctor<c10::BFloat16>",)}
    out = {k: {"ms": 0.0, "count": 0} for k in kinds}
    for key, (ms, n) in by_kernel.items():
        for kind, pats in kinds.items():
            if any(p in key for p in pats):
                out[kind]["ms"] += ms
                out[kind]["count"] += n
    return out


def profile_block(torch, dev, eng, prompts, B, sampling=None,
                  recurrent=False, extras=None):
    """Where the time goes: one-block requests, one per prompt (one
    admission, 32 refinement iterations, one commit pass), once without
    and once under the profiler; device time by kernel, grouped, and the
    share of the wall time the device was busy, of the profiled wall and
    of the unprofiled one (the profiler slows the host, not the kernels).
    ``sampling(i)``, where given, is request i's ``SamplingParams``; the
    per-lane draw's kernels (DRAW_KERNEL_MARKS) then form a group of their
    own, taken out of "other"; ``recurrent``: as ``device_groups``;
    ``extras[i]``, where given, request i's extras."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving import Request
    reqs = [Request(prompt=p, id=1000 + i, max_tokens=B,
                    params=None if sampling is None else sampling(i),
                    extras=None if extras is None else extras[i])
            for i, p in enumerate(prompts)]
    _, plain_wall = _timed(torch, dev, lambda: eng.generate(reqs))
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng.generate(reqs)
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    groups, by_kernel = device_groups(prof, recurrent)
    if sampling is not None:
        groups["draw"] = 0.0
        for key, (ms, _) in by_kernel.items():
            if (not any(g in key for g in ("decode_attn", "decode_merge",
                                           "block_attn", "select_", "xent_"))
                    and any(m in key for m in DRAW_KERNEL_MARKS)):
                groups["draw"] += ms
                groups["other"] -= ms
    busy = sum(groups.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:10]
    return {"phase": "profile", "requests": len(reqs), "wall_ms": wall * 1e3,
            "device_busy_ms": busy, "idle_share": 1 - busy / (wall * 1e3),
            "unprofiled_wall_ms": plain_wall * 1e3,
            "idle_share_of_unprofiled_wall": 1 - busy / (plain_wall * 1e3),
            "trace_read_s": time.perf_counter() - t0 - wall,
            "device_ms_by_group": groups, "calls": eng.call_counts(),
            "kernels_launched": sum(n for _, n in by_kernel.values()),
            "top_kernels": [{"name": k[:120], "ms": ms, "count": n}
                            for k, (ms, n) in top]}


# ---------------------------------------------------------------------------
# phase 4: kernel path against plain path
# ---------------------------------------------------------------------------
def phase_paths(torch, dev):
    from repro_torch.configs import get_config
    from repro_torch.core import cache as C
    from repro_torch.core import diffusion as D
    from repro_torch.core import masks
    from repro_torch.core.block_loop import (
        SamplerSpec,
        init_canvas,
        lane_block_forward,
    )
    from repro_torch.kernels.block_attn import flash_block_attention
    from repro_torch.kernels.block_attn import ref as bref
    from repro_torch.kernels.decode_attn import (
        decode_attention,
        paged_decode_attention,
    )
    from repro_torch.kernels.decode_attn import ref as dref
    from repro_torch.kernels.select import fused_select
    from repro_torch.kernels.select import ref as sref
    from repro_torch.models import forward, unembed_matrix

    cfg = get_config("qwen2-0.5b")
    P, B, tau = 128, 32, 0.9
    params = _random_params(torch, cfg, dev, "float32")
    spec = SamplerSpec(prompt_len=P, gen_len=B, block_size=B,
                       conf_threshold=tau)
    rng = np.random.default_rng(1)
    prompts = torch.as_tensor(rng.integers(0, cfg.mask_token_id, (2, P)),
                              device=dev)
    rows = np.ones((2,), bool)

    def prefill(attn):
        return forward(params, prompts, cfg=cfg, device=dev,
                       mode=masks.BLOCK_CAUSAL, prompt_len=P, block_size=B,
                       return_logits=False,
                       prefill_attention_fn=attn).emissions

    em_kernel, em_plain = prefill(flash_block_attention), prefill(
        bref.block_attention)
    prefill_err = max((a[k] - b[k]).abs().max().item()
                      for a, b in zip(em_kernel, em_plain) for k in a)
    dense_k = C.commit_rows(C.init_cache(cfg, 2, P + B, dtype="float32",
                                         device=dev), em_kernel, 0, rows)
    dense_p = C.commit_rows(C.init_cache(cfg, 2, P + B, dtype="float32",
                                         device=dev), em_plain, 0, rows)
    # the paged cache: lane 1's pages first and reversed, spare pages
    paged = C.init_paged_cache(cfg, 2, P + B, n_pages=3 * (P + B) // B,
                               page_size=B, dtype="float32", device=dev)
    C.alloc(paged, np.array([False, True]), 0, P)
    paged.page_table[1, :P // B] = paged.page_table[1, :P // B][::-1].copy()
    C.alloc(paged, np.array([True, False]), 0, P)
    paged.touch()
    C.commit_rows(paged, em_kernel, 0, rows)
    tokens = init_canvas(prompts, spec, cfg)
    starts = [P, P]
    w = unembed_matrix(params, cfg)
    all_block = torch.ones((1, B), dtype=torch.bool, device=dev)

    def plain_select(h, w, masked):
        c, f = sref.select_streaming(h.reshape(-1, h.shape[-1]), w,
                                     masked.reshape(-1))
        return c.reshape(masked.shape), f.reshape(masked.shape)

    # each path's attention goes to both decode hooks; the cache's layout
    # picks the one that runs
    paths = {"kernel": (dense_k, decode_attention, fused_select),
             "paged": (paged, paged_decode_attention, fused_select),
             "plain": (dense_p, dref.decode_attention, plain_select)}
    iters, divergence = 0, None
    while iters < B:
        bt = tokens[:, P:P + B]
        if not (bt == cfg.mask_token_id).any():
            break
        res = {}
        for name, (cache, attn, select) in paths.items():
            h, _ = lane_block_forward(params, tokens, starts, cache, cfg=cfg,
                                      spec=spec, return_hidden=True,
                                      decode_attention_fn=attn,
                                      paged_decode_attention_fn=attn,
                                      moe_per_row=True)
            cand, conf = select(h, w, bt == cfg.mask_token_id)
            sel = D.select_threshold_in_block(conf, all_block, tau)
            res[name] = (h, cand, conf, sel,
                         torch.where(sel, cand.to(bt.dtype), bt))
        if not all(torch.equal(a, b) for a, b in zip(res["paged"],
                                                      res["kernel"])):
            raise AssertionError(f"iteration {iters}: the paged kernel path "
                                 "differs from the dense kernel path")
        if not torch.equal(res["kernel"][4], res["plain"][4]):
            h, cand, conf, sel, _ = res["plain"]
            kc, ksel, kconf = res["kernel"][1], res["kernel"][3], \
                res["kernel"][2]
            if not torch.equal(sel, ksel):   # another position was chosen
                lane = int((sel != ksel).any(-1).nonzero()[0])
                a, b_ = int(sel[lane].float().argmax()), \
                    int(ksel[lane].float().argmax())
                gap = abs(float(conf[lane, a] - conf[lane, b_])) / float(
                    conf[lane, a])
                kind = "relative confidence gap"
            else:                            # another token at one position
                lane, pos = [int(x) for x in
                             ((cand != kc) & sel).nonzero()[0]]
                top2 = (h[lane, pos].float() @ w.float().t()).topk(2).values
                gap = float(top2[0] - top2[1])
                kind = "top-2 logit gap"
            divergence = {"iteration": iters, "lane": lane, "kind": kind,
                          "gap": gap}
            log(f"paths diverge at iteration {iters}, lane {lane}: {kind} "
                f"{gap}")
            if gap >= NEAR_TIE:
                raise AssertionError("kernel and plain paths diverge away "
                                     "from a near-tie")
            break
        tokens[:, P:P + B] = res["kernel"][4]
        iters += 1
    log(json.dumps({"phase": "paths", "config": "qwen2-0.5b",
                    "dtype": "float32", "iterations_compared": iters,
                    "prefill_emissions_max_abs_diff": prefill_err,
                    "paged_equals_dense_kernel_path": True,
                    "equal": divergence is None,
                    "divergence": divergence}))

# ---------------------------------------------------------------------------
# phase 5: training at full width
# ---------------------------------------------------------------------------
def _finite(torch, metrics, what):
    bad = {k: float(v) for k, v in metrics.items()
           if not torch.isfinite(torch.as_tensor(v)).all()}
    if bad:
        raise AssertionError(f"{what}: non-finite metrics {bad}")


WARM_TEACHER_STEPS = 3
WARM_STUDENT_STEPS = 5


def spread(xs):
    """Median, least and most of repeated timings, and the timings."""
    return {"median": float(np.median(xs)), "min": min(xs), "max": max(xs),
            "all": xs}


def _timed(torch, dev, fn):
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0


def check_collection(torch, teacher, ds, cfg, cdlm, per_forward=64):
    """The collected trajectories against the plain collector step, teacher
    forced: every step s of every lane is replayed from its canvas
    ``state_at(final, finalized_at, s)`` through ``top1_step`` with
    ``fused_select=False`` (generic attention, fp32 logits of the block),
    once with the bf16 teacher and once with its fp32 copy.

    - hidden: at the position finalized at step s, the recorded hidden
      (kernel route, bf16) may lie no further from the fp32 replay than
      the plain bf16 replay does, by 2x in the largest element error and
      1.5x in the root-mean-square error over all recorded positions (the
      routes differ only in the attention core, and the kernel keeps its
      scores and probabilities in fp32; the largest errors are outliers
      of the bf16 layers both routes share, so the rms catches a small
      error everywhere that the max would not);
    - token: the kernel took k = argmax of the logits L_k of the recorded
      hidden; the plain step takes j = argmax of L_p. Since L_k[k] >=
      L_k[j], L_p[j] - L_p[k] <= 2 delta + eps, delta = max_v |L_p - L_k|
      and eps the fp32 accumulation bound d u max(|h| |W|);
    - position: the kernel took the masked position p of the largest
      confidence; log conf moves by at most 2 delta when the logits move by
      delta, so log conf_p(p*) - log conf_p(p) <= 2 (delta_p + delta_p*)
      for the plain step's choice p*. delta_p* was not recorded (p* is
      recorded at its own step); it is taken as 1.5 x the largest delta
      over all recorded positions, each position of the span being
      recorded once.
    Returns the record."""
    from repro_torch.core.block_loop import SamplerSpec, top1_step
    from repro_torch.core.trajectory import state_at
    from repro_torch.models import unembed_matrix
    from repro_torch.tree import tree_map

    prompt, final = ds["prompt"], ds["final"]
    fat, hid = ds["finalized_at"], ds["hidden"]
    n, P = prompt.shape
    G, B = cdlm.gen_length, cdlm.block_size
    dev = prompt.device
    spec = SamplerSpec(prompt_len=P, gen_len=G, block_size=B)
    assert not spec.fused_select
    t32 = tree_map(lambda x: x.float(), teacher)
    w = unembed_matrix(teacher, cfg).float()
    w_abs = w.abs()
    k_steps = max(1, per_forward // n)
    lanes = torch.arange(n, device=dev)
    err_kernel = err_plain = err_kp = 0.0
    sq_kernel = sq_plain = 0.0
    tok_rows, pos_rows = [], []
    n_checked = 0
    with torch.no_grad():
        groups = [(g0, s0) for g0 in range(0, G, B)
                  for s0 in range(g0, g0 + B, k_steps)]
        for g0, s0 in groups:
            steps = torch.arange(s0, min(s0 + k_steps, g0 + B), device=dev)
            k = len(steps)
            start = P + g0
            gen = state_at(final[None], fat[None], steps, cfg.mask_token_id)
            canv = torch.cat([prompt[None].expand(k, n, P), gen],
                             -1).reshape(k * n, P + G)
            _, conf_p, h_p = top1_step(teacher, canv, start, cfg=cfg,
                                       spec=spec)
            _, _, h_32 = top1_step(t32, canv, start, cfg=cfg, spec=spec)
            rec = fat[None, :, g0:g0 + B] == steps[:, None, None]
            valid = (rec.sum(-1) == 1).reshape(-1)
            p_rec = rec.int().argmax(-1)                          # (k, n)
            h_rec = hid[:, g0:g0 + B][lanes[None], p_rec].reshape(k * n, -1)
            rows = torch.arange(k * n, device=dev)
            pr = p_rec.reshape(-1)
            hp = h_p[rows, pr].float()
            h32 = h_32[rows, pr]
            v = valid
            n_checked += int(v.sum())
            err_kernel = max(err_kernel, (h_rec - h32)[v].abs().max().item())
            err_plain = max(err_plain, (hp - h32)[v].abs().max().item())
            err_kp = max(err_kp, (h_rec - hp)[v].abs().max().item())
            sq_kernel += float(((h_rec - h32)[v] ** 2).sum())
            sq_plain += float(((hp - h32)[v] ** 2).sum())
            L_p, L_k = hp @ w.t(), h_rec @ w.t()
            delta = (L_p - L_k).abs().max(-1).values
            eps = cfg.d_model * U32 * (h_rec.abs() @ w_abs.t()).max(-1).values
            tok = final[:, g0:g0 + B][lanes[None], p_rec].reshape(-1)
            gap = (L_p.max(-1).values
                   - L_p.gather(-1, tok[:, None].long())[:, 0])
            tok_rows.append(torch.stack([gap, 2 * delta + eps], -1)[v])
            conf_p = conf_p.float()                               # (k*n, B)
            lc = torch.where(torch.isfinite(conf_p), torch.log(conf_p),
                             -torch.inf)
            pos_gap = lc.max(-1).values - lc[rows, pr]
            pos_rows.append(torch.stack([pos_gap, delta], -1)[v])
            del h_p, h_32, L_p, L_k
    del t32, w_abs
    tok_rows, pos_rows = torch.cat(tok_rows), torch.cat(pos_rows)
    rms_kernel = (sq_kernel / (n_checked * cfg.d_model)) ** 0.5
    rms_plain = (sq_plain / (n_checked * cfg.d_model)) ** 0.5
    if not (err_kernel <= 2 * err_plain and rms_kernel <= 1.5 * rms_plain):
        raise AssertionError(
            f"collection: recorded hidden from the fp32 replay: max "
            f"{err_kernel}, rms {rms_kernel}; plain bf16 replay: max "
            f"{err_plain}, rms {rms_plain} (limits 2x max, 1.5x rms)")
    tok_diff = tok_rows[:, 0] > 0
    if not bool((tok_rows[:, 0] <= tok_rows[:, 1]).all()):
        worst = float((tok_rows[:, 0] / tok_rows[:, 1]).max())
        raise AssertionError(f"collection: a recorded token is not the plain "
                             f"argmax beyond its tie limit ({worst} of it)")
    d_max = float(pos_rows[:, 1].max())
    pos_lim = 2 * (pos_rows[:, 1] + 1.5 * d_max) + 1e-5
    pos_diff = pos_rows[:, 0] > 0
    if not bool((pos_rows[:, 0] <= pos_lim).all()):
        worst = float((pos_rows[:, 0] / pos_lim).max())
        raise AssertionError(f"collection: a recorded position is not the "
                             f"plain step's choice beyond its tie limit "
                             f"({worst} of it)")
    return {"replayed_steps": n_checked, "of": n * G,
            "hidden_err_kernel_vs_fp32": err_kernel,
            "hidden_err_plain_vs_fp32": err_plain,
            "hidden_err_kernel_vs_plain": err_kp,
            "hidden_rms_kernel_vs_fp32": rms_kernel,
            "hidden_rms_plain_vs_fp32": rms_plain,
            "token_differs_from_plain": int(tok_diff.sum()),
            "token_worst_share_of_limit": float(
                (tok_rows[:, 0] / tok_rows[:, 1]).max()),
            "position_differs_from_plain": int(pos_diff.sum()),
            "position_worst_share_of_limit": float(
                (pos_rows[:, 0] / pos_lim).max()),
            "logit_delta_max": d_max}


def compare_collection(torch, dev, teacher, ds, cfg, cdlm):
    """The collected batch (its forward a CUDA graph) collected again
    eagerly and through the graph, in that order: every trajectory
    (canvas, finalized_at, hidden) equal to the collected one bit for bit.
    Returns the ms per collection forward of each run."""
    from repro_torch.core.block_loop import SamplerSpec, _top1_loop
    prompt = ds["prompt"]
    P, G = prompt.shape[1], cdlm.gen_length
    spec = SamplerSpec(prompt_len=P, gen_len=G, block_size=cdlm.block_size,
                       fused_select=True)
    from repro_torch.core.block_loop import _canvas_hidden
    from repro_torch.graphs import Graph
    ms = {}
    for name, graphs in (("eager", False), ("graph", None)):
        (res, fat, hid), wall = _timed(torch, dev, lambda: _top1_loop(
            teacher, prompt, cfg=cfg, spec=spec, record_hidden=True,
            graphs=graphs))
        if not (torch.equal(res.tokens[:, :P], prompt)
                and torch.equal(res.tokens[:, P:], ds["final"])
                and torch.equal(fat, ds["finalized_at"])
                and torch.equal(hid, ds["hidden"])):
            raise AssertionError(f"collection: the {name} collector's "
                                 "trajectories differ from the collected "
                                 "batch's")
        ms[name] = wall * 1e3 / G
    # the forward's replay alone, back to back (CUDA events): its device
    # time; the rest of a collection step is the eager selection
    canvas = torch.cat([prompt, ds["final"]], 1)
    with torch.no_grad():
        graph = Graph(lambda: _canvas_hidden(teacher, canvas, cfg=cfg,
                                             spec=spec))
        replay_ms = time_ms(torch, graph.replay, 20)
    del graph
    return {"forwards": G, "equal": True, "eager_ms_per_forward": ms["eager"],
            "graph_ms_per_forward": ms["graph"],
            "graph_forward_replay_ms": replay_ms}


def phase_training(torch, dev):
    """Teacher SFT -> greedy collection -> student (full and LoRA) through
    the trainer's entry points at qwen2-0.5b's full width, counted; then
    the collection replayed through the plain collector step, the student
    step's DLM term with the kernel and with the plain cross-entropy, warm
    step times and a profiled student step."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import CDLMConfig, TrainConfig, get_config
    from repro_torch.core import diffusion as D
    from repro_torch.core import losses as LS
    from repro_torch.core import trajectory
    from repro_torch.data import Corpus, TaskSpec
    from repro_torch.kernels.xent import fused_xent
    from repro_torch.kernels.xent import ref as xref
    from repro_torch.models import forward
    from repro_torch.optim import adamw
    from repro_torch.training import steps as S
    from repro_torch.training import trainer

    cfg = get_config("qwen2-0.5b")
    P, G, B, b = 128, 256, 32, 4
    task = TaskSpec("sort", vocab_size=cfg.vocab_size, prompt_len=P,
                    gen_len=G, sort_k=P - 2, sort_range=4096)
    corpus = Corpus(task, 64, seed=0)
    cdlm = CDLMConfig(block_size=B, gen_length=G, prompt_length=P,
                      temperatures=(0.0,))
    tcfg = TrainConfig(learning_rate=2e-5, steps=2, batch_size=b,
                       remat=False)
    scfg = dataclasses.replace(tcfg, learning_rate=5e-4)
    lcfg = dataclasses.replace(scfg, steps=1, use_lora=True, lora_rank=32,
                               lora_alpha=32.0, remat=True)
    hist = {"teacher": [], "student": [], "lora": []}
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    teacher, t_teacher = _timed(torch, dev, lambda: trainer.train_teacher(
        cfg, corpus, tcfg, device=dev, verbose=False,
        history=hist["teacher"]))
    ds, t_collect = _timed(torch, dev, lambda: trainer.collect_dataset(
        teacher, cfg, cdlm, corpus, n_examples=b, batch=b, verbose=False))
    student, t_student = _timed(torch, dev, lambda: trainer.train_student(
        teacher, ds, cfg, cdlm, scfg, efficient_loss=True, verbose=False,
        history=hist["student"]))
    merged, t_lora = _timed(torch, dev, lambda: trainer.train_student(
        teacher, ds, cfg, cdlm, lcfg, efficient_loss=True, verbose=False,
        history=hist["lora"]))
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)

    for stage, rows in hist.items():
        for i, m in enumerate(rows):
            _finite(torch, m, f"{stage} step {i}")
    n_ce = tcfg.steps + scfg.steps + lcfg.steps
    forwards = cdlm.gen_length     # one batch: a forward per step
    # the losses' forwards take the plain ops; the collection's the passes
    want = {"decode_attention": 0, "paged_decode_attention": 0,
            "fused_select": forwards,
            "block_attention": forwards * cfg.n_layers,
            "xent_forward": n_ce, "xent_backward": n_ce,
            **elementwise_launches(cfg, forwards)}
    if launches != want:
        raise AssertionError(f"training: launches {launches} != {want}")
    fat, final = ds["finalized_at"], ds["final"]
    if not (ds["hidden"].shape == (b, G, cfg.d_model)
            and bool(torch.isfinite(ds["hidden"]).all())
            and bool(((fat >= -1) & (fat < G)).all())):
        raise AssertionError("collection: bad shapes or values")
    steps = torch.arange(G, device=dev)
    clean = (final != cfg.mask_token_id).all(-1)
    perm = (fat.sort(-1).values == steps).all(-1)
    if not bool((perm | ~clean).all()):
        raise AssertionError("collection: a lane without a mask token did "
                             "not finalize one position per step")
    for tree in (student, merged):
        if not all(bool(torch.isfinite(x).all())
                   for x in (tree["embed"]["tok"],
                             tree["slots"][0]["attn"]["wq"])):
            raise AssertionError("student params not finite")

    collection = compare_collection(torch, dev, teacher, ds, cfg, cdlm)
    log(json.dumps({"phase": "collection graph vs eager", **collection}))

    replay = check_collection(torch, teacher, ds, cfg, cdlm)
    log(json.dumps({"phase": "collection replay", **replay}))

    # one student step's DLM term, the only place its cross-entropy enters,
    # with the kernel and with the plain cross-entropy: loss and gradients
    gen = torch.Generator(device=dev).manual_seed(7)
    batch = trajectory.sample_training_pair(ds, gen, b, cfg=cfg, cdlm=cdlm)
    draws = S.dlm_draws(gen, b, G, dev)
    head = teacher["embed"]
    plain_xent = lambda h, w, y: xref.xent_streaming(h, w, y)[0]  # noqa
    with torch.no_grad():
        total, mk = S.cdlm_loss(student, None, batch, draws, cfg=cfg,
                                cdlm=cdlm, teacher_head=head, use_lora=False,
                                efficient_loss=True)
    masked_gt, m = D.mask_tokens_from(draws["u"], batch["gt"], draws["t"],
                                      cfg.mask_token_id)
    with torch.no_grad():
        hid = forward(student, torch.cat([batch["prompt"], masked_gt], 1),
                      cfg=cfg, device=dev, mode="block_causal", prompt_len=P,
                      block_size=B, return_logits=False).hidden[:, P:]
    grads = {}
    for name, fn in (("kernel", fused_xent), ("plain", plain_xent)):
        h = hid.clone().requires_grad_()
        w = student["embed"]["tok"].clone().requires_grad_()
        loss = LS.dlm_loss_from_hidden(h, w, batch["gt"], m, draws["t"], fn)
        grads[name] = (float(loss.detach()),
                       *torch.autograd.grad(loss, (h, w)))
    ok_h, err_h = grad_limit(torch, grads["kernel"][1], grads["plain"][1],
                             "bfloat16")
    ok_w, err_w = grad_limit(torch, grads["kernel"][2], grads["plain"][2],
                             "bfloat16")
    dlm_k, dlm_p = grads["kernel"][0], grads["plain"][0]
    # the step's total with the plain cross-entropy: its KL terms are the
    # same code on both sides, only the DLM term changes
    total_p = float(total) + cdlm.w_dlm * (dlm_p - float(mk["dlm"]))
    rel = {"dlm": abs(dlm_k - dlm_p) / abs(dlm_p),
           "total": abs(float(total) - total_p) / abs(total_p),
           "dlm_in_step_vs_alone": abs(float(mk["dlm"]) - dlm_k) / abs(dlm_k)}
    if not (ok_h and ok_w and all(v <= 1e-4 for v in rel.values())):
        raise AssertionError(f"student DLM term: losses rel {rel}, dh "
                             f"{err_h} ({ok_h}), dW {err_w} ({ok_w})")
    del grads, hid

    # warm step times (median of several), then one profiled student step
    opt_t = adamw.init(teacher)
    tstep = S.make_dlm_pretrain_step(cfg, tcfg)
    tb = trainer._batch(next(corpus.batches(b, seed=3)), dev)
    t_tsteps = [_timed(torch, dev, lambda: tstep(
        teacher, opt_t, tb, S.dlm_draws(gen, b, G, dev)))[1]
        for _ in range(WARM_TEACHER_STEPS)]
    del opt_t
    opt_s = adamw.init(student)
    sstep = S.make_cdlm_step(cfg, cdlm, scfg, efficient_loss=True)
    t_ssteps = [_timed(torch, dev, lambda: sstep(
        student, opt_s, None, head, batch, draws))[1]
        for _ in range(WARM_STUDENT_STEPS)]

    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sstep(student, opt_s, None, head, batch, draws)
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    groups, by_kernel = device_groups(prof)
    busy = sum(groups.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:10]
    rec = {"phase": "training", "config": "qwen2-0.5b", "dtype": "bfloat16",
           "batch": b, "prompt_len": P, "gen": G, "block": B,
           "launches": launches, "teacher_s": t_teacher,
           "teacher_s_per_step": t_teacher / tcfg.steps,
           "collect_s": t_collect, "collect_forwards": forwards,
           "collect_s_per_forward": t_collect / forwards,
           "student_s": t_student,
           "student_s_per_step": t_student / scfg.steps,
           "lora_student_s": t_lora,
           "warm_teacher_step_s": spread(t_tsteps),
           "warm_student_step_s": spread(t_ssteps),
           "losses": {k: [{n: float(v) for n, v in m.items()} for m in rows]
                      for k, rows in hist.items()},
           "collected_lanes_with_mask_token": int((~clean).sum()),
           "collection_graph_vs_eager": collection,
           "collection_replay": replay, "kernel_vs_plain_rel": rel,
           "dlm_dh_max_abs_err": err_h, "dlm_dw_max_abs_err": err_w,
           "max_memory_allocated_bytes": peak}
    log(json.dumps(rec))
    log(json.dumps({
        "phase": "profile", "what": "one full fine-tune student step",
        "wall_ms": wall * 1e3, "device_busy_ms": busy,
        "idle_share": 1 - busy / (wall * 1e3), "device_ms_by_group": groups,
        "kernels": sum(n for _, n in by_kernel.values()),
        **elementwise_kinds(by_kernel),
        "top_kernels": [{"name": k[:120], "ms": ms, "count": n}
                        for k, (ms, n) in top]}))
    return launches


# ---------------------------------------------------------------------------
# phase 6: sampled serving and the HTTP frontend
# ---------------------------------------------------------------------------
GUMBEL_ULP = 2          # Gumbel noise, CUDA against the CPU: ulps of max(|g|, 1)
STATIC_GEN = 32         # the static engine's sampled generation (a block)
HTTP_MAX_TOKENS = 64    # each HTTP completion's cap (2 blocks)
COLLECT_SHAPE = (4, 128, 256, 32)   # phase 5's collection: b, P, G, block
PAGED_IDS = (1, 3, 6, 11)   # (b)'s paged run: caps 64, 32, 32, 32


def _ulps(torch, got, want):
    """|got - want| in ulps of max(|want|, 1), the noise's scale where it
    meets the logits."""
    scale = torch.maximum(want.abs(), torch.ones_like(want))
    ulp = torch.nextafter(scale, torch.full_like(scale, float("inf"))) - scale
    return float(((got - want).abs() / ulp).max())


def check_prng(torch, dev, cfg):
    """(a) The threefry stream on the card: keys and bits at the per-lane
    draw's shape (8 lanes, 32 x V) equal the CPU's bit for bit, the Gumbel
    noise within GUMBEL_ULP; one per-lane draw and the whole per-lane
    selection timed with CUDA events, beside the greedy selection."""
    from repro_torch import prng
    from repro_torch.core import diffusion as D
    shape = (32, cfg.vocab_size)
    keys = prng.split(prng.key(42), 8)
    kd = keys.to(dev)
    for what, fn in (("split", lambda k: prng.split(k, 3)),
                     ("bits", lambda k: prng.bits(k, shape))):
        if not torch.equal(fn(kd).cpu(), fn(keys)):
            raise AssertionError(f"prng: {what} on the card differs from "
                                 "the CPU's")
    ulps = _ulps(torch, prng.gumbel(kd, shape).cpu(),
                 prng.gumbel(keys, shape))
    if ulps > GUMBEL_ULP:
        raise AssertionError(f"prng: Gumbel noise {ulps} ulp from the CPU's")
    gen = torch.Generator(device=dev).manual_seed(0)
    logits = 3 * torch.randn((8,) + shape, generator=gen, device=dev)
    tokens = torch.full((8, 32), cfg.mask_token_id, device=dev)
    temps = torch.full((8,), 0.7, device=dev)
    draw_ms = time_ms(torch, lambda: prng.categorical(kd, logits), 10)
    sel_ms = time_ms(torch, lambda: D.confidence_and_candidates_per_lane(
        logits, tokens, cfg.mask_token_id, temps, kd), 10)
    greedy_ms = time_ms(torch, lambda: D.confidence_and_candidates_per_lane(
        logits, tokens, cfg.mask_token_id, temps, None), 10)
    n = logits.numel()
    rec = {"phase": "prng", "draw_shape": [8, *shape], "bits_equal": True,
           "split_equal": True, "gumbel_max_ulp": ulps,
           "draw_ms": draw_ms,
           "draw_bytes_bound_ms": bound_ms(n * 4, 0, "float32")[0],
           "per_lane_select_sampled_ms": sel_ms,
           "per_lane_select_greedy_ms": greedy_ms}
    log(json.dumps(rec))
    return rec


def _sampled_trace(ctx, sampling_params):
    """Phase 3's 12 requests, every other one at temperature 0.7 with its
    own seed."""
    from repro_torch.serving import Request
    caps, prompts = ctx["caps"], ctx["prompts"]
    return [Request(prompt=prompts[i], id=i, max_tokens=caps[i],
                    params=(sampling_params(temperature=0.7, seed=100 + i)
                            if i % 2 else None))
            for i in range(len(caps))]


def _dense_launches(cfg, calls, layout):
    """The launches of an engine without fused select: the call accounting
    of ``check_launches`` with no select."""
    cached = cfg.n_layers * (calls["refine"] + calls["commit"])
    return {"decode_attention": cached if layout == "dense" else 0,
            "fused_select": 0,
            "paged_decode_attention": cached if layout == "paged" else 0,
            "block_attention": cfg.n_layers * calls["admit"],
            "xent_forward": 0, "xent_backward": 0,
            **elementwise_launches(cfg, calls["admit"] + calls["refine"]
                                   + calls["commit"])}


def check_sampled_serving(torch, dev, ctx):
    """(b) Phase 3's trace with every other request sampled, through an
    engine without fused select: graph, eager, graph, every run equal in
    tokens, steps, gen_length, finish_reason, call counts and launches
    (which equal the call accounting); phase 3's greedy trace through the
    dense-logits greedy iteration; then four of the requests on the paged
    layout through its graphs, tokens and steps equal to the dense
    layout's; a profiled sampled block. Returns (record, the graph engine, the eager engine,
    the first graph run's launches)."""
    import dataclasses

    from repro_torch.serving import ContinuousEngine, Request, SamplingParams
    cfg, P, B = ctx["cfg"], ctx["P"], ctx["B"]
    serve = dataclasses.replace(ctx["serve"], fused_select=False)
    engines = {name: ContinuousEngine(ctx["params"], cfg, serve,
                                      prompt_len=P, device=dev,
                                      graphs=graphs)
               for name, graphs in (("graph", None), ("eager", False))}
    for eng in engines.values():
        eng.warmup(per_request=True)
    if set(engines["graph"]._graphs) != {"dense", "sampled", "commit"}:
        raise AssertionError(f"sampled serving: graphs "
                             f"{sorted(engines['graph']._graphs)}")
    runs, ref, first = [], None, None
    for name in ("graph", "eager", "graph"):
        eng = engines[name]
        outs, wall, counts = serve_counted(
            torch, dev, eng, _sampled_trace(ctx, SamplingParams))
        calls = eng.call_counts()
        check_outputs(cfg, outs, dict(enumerate(ctx["caps"])), B)
        want = _dense_launches(cfg, calls, "dense")
        if counts != want:
            raise AssertionError(f"sampled serving, {name}: launches "
                                 f"{counts} != {want}")
        got = ({rid: (o.tokens.tolist(), o.steps, o.gen_length,
                      o.finish_reason) for rid, o in outs.items()},
               calls, counts)
        ref = ref or got
        first = first or counts
        if got != ref:
            raise AssertionError(f"sampled serving: the {name} run differs "
                                 "from the first graph run")
        tokens = sum(o.gen_length for o in outs.values())
        runs.append({"path": name, "wall_s": wall, "tps": tokens / wall,
                     "mean_latency_s": float(np.mean(
                         [o.latency_s for o in outs.values()]))})
    greedy = {rid: o.tokens.tolist() for rid, o in ctx["outs"].items()}
    sampled_differ = sum(ref[0][rid][0] != greedy[rid]
                         for rid in range(1, len(greedy), 2))
    # phase 3's greedy trace through the dense-logits greedy iteration
    outs, wall, counts = serve_counted(torch, dev, engines["graph"], [
        Request(prompt=ctx["prompts"][i], id=i, max_tokens=c)
        for i, c in enumerate(ctx["caps"])])
    check_outputs(cfg, outs, dict(enumerate(ctx["caps"])), B)
    if counts != _dense_launches(cfg, engines["graph"].call_counts(),
                                 "dense"):
        raise AssertionError(f"dense greedy: launches {counts}")
    tokens = sum(o.gen_length for o in outs.values())
    runs.append({"path": "graph, dense-logits greedy", "wall_s": wall,
                 "tps": tokens / wall, "mean_latency_s": float(np.mean(
                     [o.latency_s for o in outs.values()]))})
    dense_equal_fused = sum(o.tokens.tolist() == greedy[rid]
                            for rid, o in outs.items())
    # the paged layout on the trace's short requests (a lane's tokens do
    # not depend on its batch)
    peng = ContinuousEngine(ctx["params"], cfg, dataclasses.replace(
        serve, cache_layout="paged"), prompt_len=P, device=dev)
    peng.warmup(per_request=True)
    outs, wall, counts = serve_counted(torch, dev, peng, [
        r for r in _sampled_trace(ctx, SamplingParams)
        if r.id in PAGED_IDS])
    if counts != _dense_launches(cfg, peng.call_counts(), "paged"):
        raise AssertionError(f"sampled serving, paged: launches {counts}")
    for rid, o in outs.items():
        if (o.tokens.tolist(), o.steps) != ref[0][rid][:2]:
            raise AssertionError(f"sampled serving: paged request {rid} "
                                 "differs from the dense layout")
    tokens = sum(o.gen_length for o in outs.values())
    runs.append({"path": "graph, paged", "wall_s": wall,
                 "tps": tokens / wall, "mean_latency_s": float(np.mean(
                     [o.latency_s for o in outs.values()]))})
    del peng
    profile = profile_block(
        torch, dev, engines["graph"], ctx["prompts"][:8], B,
        sampling=lambda i: SamplingParams(temperature=0.7, seed=i))
    rec = {"phase": "sampled serving", "config": "qwen2-0.5b",
           "dtype": "bfloat16", "requests": len(ref[0]),
           "sampled_requests": len(ref[0]) // 2, "temperature": 0.7,
           "calls": ref[1], "launches": ref[2], "equal": True,
           "paged_equals_dense": True,
           "sampled_tokens_differ_from_greedy": sampled_differ,
           "dense_greedy_equal_fused_greedy": dense_equal_fused,
           "runs": runs, "fused_greedy_phase3": ctx["rec"],
           "profiled_sampled_block": profile}
    log(json.dumps(rec))
    return rec, engines, first


def static_ab(torch, dev, ctx, name, serve, reqs, profile=False,
              outputs=None):
    """Decoder ``name`` through the static engine eagerly
    (``graphs=False``) and through its CUDA graphs (captured at warmup,
    once per engine), in turns: eager, graph, graph, eager. Every run
    equals the first in tokens, steps, gen_length, finish_reason, calls
    and every kernel's launches, which must equal the decoder's accounting
    (``decoder_launches``); the eager engine captures nothing. Prints
    each path's tokens/s and ms per call; ``profile``: a profiled batch of
    each engine too (``profile_block``). Returns (record, the first graph
    run's launches). ``ctx`` may also name the engines' ``pos_offset``,
    ``use_long_window`` and the profiled batch's ``extras`` (one dict a
    prompt); ``outputs``, a list, receives the first run's outputs."""
    from repro_torch.serving import Engine
    cfg, P = ctx["cfg"], ctx["P"]
    engines = {path: Engine(ctx["params"], cfg, serve, prompt_len=P,
                            pos_offset=ctx.get("pos_offset", 0),
                            use_long_window=ctx.get("use_long_window", False),
                            device=dev, graphs=graphs)
               for path, graphs in (("eager", False), ("graph", None))}
    engines["graph"].warmup()
    captured = sorted(engines["graph"]._graphs)
    runs, ref, first = {"eager": [], "graph": []}, None, None
    for path in ("eager", "graph", "graph", "eager"):
        eng = engines[path]
        outs, wall, counts = serve_counted(torch, dev, eng, reqs)
        calls = eng.call_counts()["total"]
        want, want_calls, iters = decoder_launches(cfg, name, counts, calls,
                                                   eng.spec)
        bad = {k: (counts[k], v) for k, v in want.items()
               if v is not None and counts[k] != v}
        if name == "interval_cache" and want["block_attention"] is None \
                and counts["block_attention"] < cfg.n_layers:
            bad["block_attention"] = (counts["block_attention"],
                                      ">= layers")
        if bad or calls != want_calls:
            raise AssertionError(f"{name}, {path}: launches {counts} / calls "
                                 f"{calls} against the accounting {want}, "
                                 f"{want_calls}: {bad}")
        for rid, o in outs.items():
            if (np.any(o.tokens[:o.gen_length] == cfg.mask_token_id)
                    or not 1 <= o.steps <= serve.gen_length
                    or (name not in ("ar", "vanilla") and o.steps > iters)):
                raise AssertionError(f"{name}, {path}: request {rid} steps "
                                     f"{o.steps}, mask token left")
        got = ({rid: (o.tokens.tolist(), o.steps, o.gen_length,
                      o.finish_reason) for rid, o in outs.items()},
               calls, counts)
        ref = ref or got
        first = first or (counts if path == "graph" else None)
        if got != ref:
            raise AssertionError(f"{name}: the {path} run differs from the "
                                 "first eager run")
        tokens = sum(o.gen_length for o in outs.values())
        runs[path].append({"wall_s": wall, "tps": tokens / wall,
                           "ms_per_call": wall * 1e3 / calls,
                           "mean_latency_s": float(np.mean(
                               [o.latency_s for o in outs.values()]))})
    if engines["eager"]._graphs is not None or not captured \
            or sorted(engines["graph"]._graphs) != captured:
        raise AssertionError(f"{name}: graphs {captured} captured, "
                             f"{sorted(engines['graph']._graphs)} after")
    profiles = {}
    if profile:
        for path, eng in engines.items():
            prof = profile_block(torch, dev, eng, ctx["prompts"][:8],
                                 ctx["B"], extras=ctx.get("extras"))
            profiles[path] = {k: prof[k] for k in (
                "wall_ms", "device_busy_ms", "idle_share",
                "unprofiled_wall_ms", "idle_share_of_unprofiled_wall",
                "device_ms_by_group", "calls", "top_kernels")}
    del engines
    torch.cuda.empty_cache()
    log(f"{name}: " + "; ".join(
        f"{path} {r['tps']:.1f} tokens/s, {r['ms_per_call']:.2f} ms a call"
        for path in ("eager", "graph") for r in runs[path]))
    rec = {"decoder": name, "calls": ref[1], "iterations": iters,
           "launches": ref[2], "graphs": captured, "equal": True,
           "mean_steps": float(np.mean([v[1] for v in ref[0].values()])),
           "tokens": sum(v[2] for v in ref[0].values()), "runs": runs}
    if profiles:
        rec["profiled_batch"] = profiles
    if outputs is not None:
        outputs.append(ref[0])
    return rec, first


def check_static(torch, dev, ctx):
    """(c) The static engine's sampled decode: 8 of phase 3's prompts
    through ``Engine.generate`` at an engine default of 0.7 (no fused
    select: the scalar path's canvas-shaped draw), one block (G=32: 7a
    runs two, greedy), for every decoder
    that samples (``ar`` is greedy; phase 7a serves it), each eagerly and
    through its graphs in turns (``static_ab``). Returns (records,
    launches of each decoder's first graph run)."""
    import dataclasses

    from repro_torch.serving import Request
    base = dataclasses.replace(ctx["serve"], gen_length=STATIC_GEN,
                               scheduler="static", fused_select=False,
                               temperature=0.7)
    reqs = [Request(prompt=ctx["prompts"][i], id=i) for i in range(8)]
    recs, launches = [], []
    for name in DECODERS[:-1]:
        rec, counts = static_ab(torch, dev, ctx, name, dataclasses.replace(
            base, sampler=name), reqs)
        recs.append(rec)
        launches.append(counts)
    log(json.dumps({"phase": "static engine", "config": "qwen2-0.5b",
                    "dtype": "bfloat16", "requests": 8,
                    "prompt_len": ctx["P"], "gen": STATIC_GEN,
                    "temperature": 0.7, "fused_select": False,
                    "decoders": recs}))
    return recs, launches


def check_http(torch, dev, ctx, engines):
    """(d) ``serve_http(block=False, port=0)`` over the graphed engine of
    (b): a greedy and a seeded sampled completion, each streamed and not;
    the chunks reassemble to the non-streamed ``token_ids``, which equal
    the eager engine's ``generate``; ``/healthz`` answers 200 and
    ``/metrics`` counts the requests."""
    import urllib.request

    from repro_torch.serving import Request, SamplingParams
    from repro_torch.serving.server import serve_http
    server = serve_http(engines["graph"], "127.0.0.1", 0, block=False)
    base = "http://127.0.0.1:%d" % server.server_address[1]

    def post(body):
        req = urllib.request.Request(
            f"{base}/v1/completions", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        return urllib.request.urlopen(req, timeout=300)

    rec = {"phase": "http", "requests": []}
    try:
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            if r.status != 200:
                raise AssertionError(f"http: /healthz {r.status}")
        for i, extra in enumerate(({}, {"temperature": 0.7, "seed": 4242})):
            prompt = ctx["prompts"][i]
            body = dict(extra, prompt=prompt.tolist(),
                        max_tokens=HTTP_MAX_TOKENS)
            t0 = time.perf_counter()
            with post(body) as r:
                full = json.load(r)["choices"][0]["token_ids"]
            t_full = time.perf_counter() - t0
            streamed, chunks = [], 0
            t0 = time.perf_counter()
            with post(dict(body, stream=True)) as r:
                for raw in r:
                    line = raw.decode().strip()
                    if line == "data: [DONE]":
                        break
                    if line.startswith("data: "):
                        streamed += json.loads(line[6:])["choices"][0][
                            "token_ids"]
                        chunks += 1
            t_stream = time.perf_counter() - t0
            ref = engines["eager"].generate([Request(
                prompt=prompt, id=0, max_tokens=HTTP_MAX_TOKENS,
                params=SamplingParams(**extra) if extra else None)])[0]
            want = ref.tokens[:ref.gen_length].tolist()
            if not (streamed == full == want):
                raise AssertionError(f"http: request {i}: streamed, "
                                     "non-streamed and generate differ")
            rec["requests"].append({"sampled": bool(extra),
                                    "tokens": len(full), "chunks": chunks,
                                    "full_s": t_full, "stream_s": t_stream})
        with urllib.request.urlopen(f"{base}/metrics", timeout=30) as r:
            metrics = r.read().decode()
        for line in ("cdlm_requests_total 4",
                     "cdlm_requests_completed_total 4"):
            if line not in metrics:
                raise AssertionError(f"http: /metrics lacks {line!r}")
    finally:
        server.shutdown()
    rec["equal"] = True
    log(json.dumps(rec))
    return rec


def check_sampled_collection(torch, dev, ctx):
    """(e) One collection batch at phase 5's shape (b=4, P=128, G=256,
    block 32) at temperature 0.5 from one key, through the graph of the
    forward and eagerly: trajectories bit for bit equal; ms per forward of
    each. Returns (record, the graph run's launches)."""
    from repro_torch import prng
    from repro_torch.core.block_loop import SamplerSpec, _top1_loop
    cfg = ctx["cfg"]
    b, P, G, B = COLLECT_SHAPE
    prompts = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.mask_token_id, (b, P)), device=dev)
    spec = SamplerSpec(prompt_len=P, gen_len=G, block_size=B,
                       temperature=0.5, fused_select=True)
    got, ms, launches = {}, {}, None
    for name, graphs in (("graph", None), ("eager", False)):
        zero_counts()
        got[name], wall = _timed(torch, dev, lambda: _top1_loop(
            ctx["params"], prompts, cfg=cfg, spec=spec, record_hidden=True,
            key=prng.key(7, dev), graphs=graphs))
        counts = read_counts()
        launches = launches or counts
        want = {k: 0 for k in counts}
        want["block_attention"] = G * cfg.n_layers
        want.update(elementwise_launches(cfg, G))
        if counts != want:
            raise AssertionError(f"sampled collection, {name}: launches "
                                 f"{counts} != {want}")
        ms[name] = wall * 1e3 / G
    (rg, fg, hg), (re_, fe, he) = got["graph"], got["eager"]
    if not (torch.equal(rg.tokens, re_.tokens) and torch.equal(fg, fe)
            and torch.equal(hg, he)):
        raise AssertionError("sampled collection: graph and eager differ")
    final = rg.tokens[:, P:]
    clean = (final != cfg.mask_token_id).all(-1)
    perm = (fg.sort(-1).values == torch.arange(G, device=dev)).all(-1)
    if not bool((perm | ~clean).all()):
        raise AssertionError("sampled collection: a lane without a mask "
                             "token did not finalize one position per step")
    rec = {"phase": "sampled collection", "config": "qwen2-0.5b",
           "dtype": "bfloat16", "lanes": b, "prompt_len": P, "gen": G,
           "temperature": 0.5, "forwards": G, "equal": True,
           "graph_ms_per_forward": ms["graph"],
           "eager_ms_per_forward": ms["eager"]}
    log(json.dumps(rec))
    return rec, launches


def phase_sampled(torch, dev, ctx):
    """Phase 6: (a) the PRNG on the card, (b) sampled continuous serving,
    (c) the static engine, (d) HTTP, (e) sampled collection. Returns the
    launches of its main-path runs, summed."""
    t = time.perf_counter()
    check_prng(torch, dev, ctx["cfg"])
    log(f"phase 6a (prng): {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    _, engines, serve_launches = check_sampled_serving(torch, dev, ctx)
    log(f"phase 6b (sampled serving): {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    _, static_launches = check_static(torch, dev, ctx)
    log(f"phase 6c (static engine): {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    check_http(torch, dev, ctx, engines)
    log(f"phase 6d (http): {time.perf_counter() - t:.1f} s")
    del engines
    t = time.perf_counter()
    _, collect_launches = check_sampled_collection(torch, dev, ctx)
    log(f"phase 6e (sampled collection): {time.perf_counter() - t:.1f} s")
    total = {}
    for counts in [serve_launches, collect_launches] + static_launches:
        for name, n in counts.items():
            total[name] = total.get(name, 0) + n
    return total


# ---------------------------------------------------------------------------
# phase 7: the paper's four baseline decoders
# ---------------------------------------------------------------------------
BASELINES = ("fast_dllm", "dual_cache", "interval_cache", "ar")
DECODERS = ("vanilla", "fast_dllm", "dual_cache", "interval_cache", "cdlm",
            "ar")
BASELINE_GEN = 64           # (a)'s generation: 2 blocks of 32
PATHS_P = 64                # (b) and (c): prompt, lanes (fp32)
PATHS_LANES = 2


def decoder_launches(cfg, name, counts, calls, spec):
    """What each kernel launched in one batch of decoder ``name`` and the
    calls it must make, from its refinement iterations: with fused select
    one select each (so the iterations are the select's launches),
    otherwise the calls less the decoder's other forwards. The block
    attention once per layer and full-sequence forward through it (none
    for ``vanilla`` without fused select: its canvas takes the generic
    attention, as the JAX collector's), the dense decode attention once
    per layer and cached forward (``cdlm``'s iterations and commit passes,
    ``ar``'s steps). interval_cache's in-loop refreshes are known exactly
    when every block ran B iterations (else only that there was the
    first). Returns (want launches or None per kernel, want calls,
    iterations). An encoder-decoder's full-sequence forwards run the
    encoder too (its layers' block attention with the decoder's); a paged
    ``cdlm`` reads its cache through the paged decode kernel."""
    Lyr, B, R, nb, G = (cfg.n_layers, spec.block_size,
                        spec.cache_refresh_interval, spec.n_blocks,
                        spec.gen_len)
    Lfull = Lyr + (cfg.n_encoder_layers if cfg.is_encoder_decoder else 0)
    fused = spec.fused_select and spec.temperature <= 0
    if name == "ar":
        return ({"decode_attention": Lyr * G, "fused_select": 0,
                 "block_attention": Lfull, "paged_decode_attention": 0,
                 "xent_forward": 0, "xent_backward": 0}, 1 + G, G)
    other = {"vanilla": 0, "fast_dllm": 0, "dual_cache": nb,
             "interval_cache": 1, "cdlm": 1 + nb}[name]
    iters = counts["fused_select"] if fused else calls - other
    if name == "vanilla":
        iters = G
    full = {"vanilla": G if spec.fused_select else 0,
            "fast_dllm": iters, "dual_cache": nb,
            "interval_cache": (1 + nb * (B // R) if iters == nb * B
                               else None),
            "cdlm": 1}[name]
    cached = Lyr * (iters + nb) if name == "cdlm" else 0
    paged = spec.cache_layout == "paged"
    return ({"decode_attention": 0 if paged else cached,
             "fused_select": iters if fused else 0,
             "block_attention": None if full is None else Lfull * full,
             "paged_decode_attention": cached if paged else 0,
             "xent_forward": 0, "xent_backward": 0}, iters + other, iters)


def check_baseline_serving(torch, dev, ctx):
    """(a) The six decoders at full width through the static engine: the
    first 8 prompts of phase 3 (P=512), G=64, block 32, tau 0.9, greedy,
    fused select, bf16, each eagerly and through its graphs in turns
    (``static_ab``): launches counted from 0 around ``generate``; they and
    the calls hold each decoder's accounting. Returns (records, summed
    launches of each decoder's first graph run)."""
    import dataclasses

    from repro_torch.serving import Request
    reqs = [Request(prompt=ctx["prompts"][i], id=i) for i in range(8)]
    recs, total = [], {}
    for name in DECODERS:
        serve = dataclasses.replace(ctx["serve"], gen_length=BASELINE_GEN,
                                    scheduler="static", sampler=name,
                                    fused_select=True)
        rec, counts = static_ab(torch, dev, ctx, name, serve, reqs,
                                profile=name == "cdlm")
        recs.append(rec)
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
    log(json.dumps({"phase": "decoder serving", "config": "qwen2-0.5b",
                    "dtype": "bfloat16", "engine": "static, eager and graphs",
                    "requests": 8, "prompt_len": ctx["P"],
                    "gen": BASELINE_GEN, "block": ctx["B"], "tau": 0.9,
                    "fused_select": True, "decoders": recs}))
    return recs, total


def _route_logits(torch, params, cfg, spec, policy, fns, tokens, blk, it,
                  cache):
    """The block logits of one threshold iteration under ``policy`` (none
    or approx), as ``core/block_loop.py::_threshold_loop`` takes them: its
    refreshes into ``cache`` first, then ``_block_forward``."""
    from repro_torch.core.block_loop import (
        STRATEGIES,
        _block_forward,
        _refresh_cache,
    )
    P, B, R = spec.prompt_len, spec.block_size, spec.cache_refresh_interval
    if (policy == "approx-dual" and blk > 0 and it == 0) or (
            policy == "approx-interval" and it % R == R - 1):
        _refresh_cache(params, tokens, cache, cfg=cfg, spec=spec, fns=fns)
    strategy = next(s for s in STRATEGIES.values()
                    if s.cache_policy == policy and s.finalize == "threshold")
    return _block_forward(params, tokens, P + blk * B, cache, cfg=cfg,
                          spec=spec, strategy=strategy, fns=fns,
                          return_hidden=False)[0]


def lockstep_threshold(torch, params, cfg, spec, prompts, routes):
    """Two greedy threshold decodes ``routes`` ((policy, attention_fns,
    refresh interval) each) replayed iteration by iteration on one shared
    canvas: the first iteration whose finalized tokens differ, with the
    gap at that decision (the top-2 logit gap of a token that differs,
    else the relative confidence gap of a position that one route took
    and the other did not: to tau, or, where no position reached tau, to
    the other most confident position), or None if the replay never
    diverges."""
    import dataclasses

    from repro_torch.core import cache as C
    from repro_torch.core import diffusion as D
    from repro_torch.core.block_loop import _refresh_cache, init_canvas
    tokens = init_canvas(prompts, spec, cfg)
    b, T = tokens.shape
    P, B, tau = spec.prompt_len, spec.block_size, spec.conf_threshold
    specs, caches = [], []
    for policy, fns, R in routes:
        rs = dataclasses.replace(spec, cache_refresh_interval=R)
        cache = None
        if policy != "none":
            cache = C.init_cache(cfg, b, T, device=tokens.device)
            _refresh_cache(params, tokens, cache, cfg=cfg, spec=rs, fns=fns)
        specs.append(rs)
        caches.append(cache)
    whole = torch.ones((1, B), dtype=torch.bool, device=tokens.device)
    done = torch.zeros((b,), dtype=torch.bool, device=tokens.device)
    for blk in range(spec.n_blocks):
        start = P + blk * B
        for it in range(B):
            bt = tokens[:, start:start + B]
            active = (bt == cfg.mask_token_id).any(-1) & ~done
            if not bool(active.any()):
                break
            picks = []
            for (policy, fns, _), rs, cache in zip(routes, specs, caches):
                lg = _route_logits(torch, params, cfg, rs, policy, fns,
                                   tokens, blk, it, cache)
                cand, conf = D.confidence_and_candidates(
                    lg, bt, cfg.mask_token_id)
                sel = D.select_threshold_in_block(conf, whole, tau) & \
                    active[:, None]
                picks.append((lg, cand, conf, sel,
                              torch.where(sel, cand.to(bt.dtype), bt)))
            (lg, cand, conf, sel, new), (_, cand2, _, sel2, new2) = picks
            if not torch.equal(new, new2):
                if not torch.equal(sel, sel2):
                    lane = int((sel != sel2).any(-1).nonzero()[0])
                    pos = int((sel[lane] != sel2[lane]).nonzero()[0])
                    c = conf[lane].double()
                    gap = abs(float(c[pos]) - tau) / tau
                    top2 = c.topk(2).values
                    if top2[0] < tau:    # the forced pick decided it
                        gap = min(gap, float(top2[0] - top2[1])
                                  / float(top2[0]))
                    kind = "relative confidence gap"
                else:
                    lane, pos = [int(x) for x in
                                 ((cand != cand2) & sel).nonzero()[0]]
                    t2 = lg[lane, pos].double().topk(2).values
                    gap, kind = float(t2[0] - t2[1]), "top-2 logit gap"
                return {"block": blk, "iteration": it, "lane": lane,
                        "position": start + pos, "kind": kind, "gap": gap}
            tokens[:, start:start + B] = new
        if spec.early_stop:
            done |= (tokens[:, start:start + B] == cfg.eos_token_id).any(-1)
    return None


def greedy_full_recompute(torch, params, cfg, prompts, G):
    """The plain AR reference: at each step a causal forward over the whole
    prefix (the generic attention, no cache), the argmax of its last row
    (EOS once a lane is done), as the greedy-next loop decides."""
    from repro_torch.core import masks
    from repro_torch.models import forward
    tokens = prompts.clone()
    b = tokens.shape[0]
    done = torch.zeros((b,), dtype=torch.bool, device=tokens.device)
    eos = torch.full((b,), cfg.eos_token_id, dtype=tokens.dtype,
                     device=tokens.device)
    with torch.no_grad():
        for _ in range(G):
            L = tokens.shape[1]
            lg = forward(params, tokens, cfg=cfg, device=tokens.device,
                         mode=masks.CAUSAL, logits_slice=(L - 1, L)).logits
            nxt = torch.where(done, eos, lg[:, -1].argmax(-1).to(
                tokens.dtype))
            done |= nxt == eos
            tokens = torch.cat([tokens, nxt[:, None]], 1)
    return tokens


def ar_divergence(torch, params, cfg, a, b, P):
    """The first position where AR canvases ``a`` and ``b`` differ, with
    the top-2 logit gap of a plain causal forward over their common
    prefix there, or None if they are equal."""
    from repro_torch.core import masks
    from repro_torch.models import forward
    diff = (a != b).nonzero()
    if diff.numel() == 0:
        return None
    lanes_pos = diff[diff[:, 1].argsort(stable=True)]
    lane, pos = [int(x) for x in lanes_pos[0]]
    with torch.no_grad():
        lg = forward(params, a[lane:lane + 1, :pos], cfg=cfg,
                     device=a.device, mode=masks.CAUSAL,
                     logits_slice=(pos - 1, pos)).logits[0, -1]
    t2 = lg.double().topk(2).values
    return {"lane": lane, "position": pos, "step": pos - P,
            "kind": "top-2 logit gap", "gap": float(t2[0] - t2[1])}


def _equal_results(torch, x, y):
    return (torch.equal(x.tokens, y.tokens)
            and torch.equal(x.steps, y.steps)
            and x.n_model_calls == y.n_model_calls
            and torch.equal(x.gen_lengths, y.gen_lengths))


def _judge(what, divergence):
    """A divergence is accepted only at a near-tie; logged either way."""
    if divergence is None:
        raise AssertionError(f"{what}: the decodes differ, but the "
                             "lockstep replay finds no differing decision")
    log(f"{what}: diverges at {json.dumps(divergence)}")
    if divergence["gap"] >= NEAR_TIE:
        raise AssertionError(f"{what}: diverges away from a near-tie")


def check_baseline_paths(torch, dev, ctx):
    """(b) Each decoder at fp32 (2 lanes, P=64, G=64, block 32, greedy,
    dense logits) with the kernels and with their plain versions, named
    through ``run_block_loop``'s ``attention_fns``: tokens, steps, calls
    and gen_lengths equal (a divergence only at a near-tie, found by a
    lockstep replay and printed with its gap); the plain runs launch no
    kernel. (c) interval_cache at R=1 against fast_dllm (a refresh before
    every forward makes the stale cache exact: equal, or a near-tie), and
    ar against a plain greedy loop that re-runs a causal full-prefix
    forward at each step."""
    import dataclasses

    from repro_torch.core.block_loop import (
        KERNELS as KF,
        PLAIN,
        STRATEGIES,
        SamplerSpec,
        run_block_loop,
    )
    # the caches the loops allocate take the config's dtype
    cfg = dataclasses.replace(ctx["cfg"], dtype="float32")
    params = _random_params(torch, cfg, dev, "float32")
    prompts = torch.as_tensor(ctx["prompts"][:PATHS_LANES, :PATHS_P],
                              device=dev)
    spec = SamplerSpec(prompt_len=PATHS_P, gen_len=BASELINE_GEN,
                       block_size=ctx["B"], conf_threshold=0.9)
    rec = {"phase": "baseline paths", "config": "qwen2-0.5b",
           "dtype": "float32", "lanes": PATHS_LANES, "prompt_len": PATHS_P,
           "gen": BASELINE_GEN, "kernel_vs_plain": {}, "cross_checks": {}}
    runs = {}
    for name in BASELINES:
        got = {}
        for path, fns in (("kernel", KF), ("plain", PLAIN)):
            zero_counts()
            got[path] = run_block_loop(params, prompts, cfg=cfg, spec=spec,
                                       strategy=STRATEGIES[name],
                                       attention_fns=fns)
            torch.cuda.synchronize(dev)
            got[path + "_launches"] = read_counts()
        if any(got["plain_launches"].values()) or not \
                got["kernel_launches"]["block_attention"] or (
                    name == "ar"
                    and not got["kernel_launches"]["decode_attention"]):
            raise AssertionError(f"{name}: launches kernel "
                                 f"{got['kernel_launches']}, plain "
                                 f"{got['plain_launches']}")
        equal = _equal_results(torch, got["kernel"], got["plain"])
        divergence = None
        if not equal:
            if name == "ar":
                divergence = ar_divergence(torch, params, cfg,
                                           got["kernel"].tokens,
                                           got["plain"].tokens, PATHS_P)
            else:
                policy = STRATEGIES[name].cache_policy
                divergence = lockstep_threshold(
                    torch, params, cfg, spec, prompts,
                    [(policy, KF, spec.cache_refresh_interval),
                     (policy, PLAIN, spec.cache_refresh_interval)])
            _judge(f"{name} kernel vs plain", divergence)
        runs[name] = got["kernel"]
        rec["kernel_vs_plain"][name] = {
            "equal": equal, "divergence": divergence,
            "calls": got["kernel"].n_model_calls,
            "mean_steps": float(got["kernel"].steps.float().mean()),
            "kernel_launches": got["kernel_launches"]}
    # (c) interval_cache at R=1 against fast_dllm
    r1 = run_block_loop(params, prompts, cfg=cfg,
                        spec=dataclasses.replace(spec,
                                                 cache_refresh_interval=1),
                        strategy=STRATEGIES["interval_cache"])
    fast = runs["fast_dllm"]
    equal = (torch.equal(r1.tokens, fast.tokens)
             and torch.equal(r1.steps, fast.steps))
    divergence = None
    if not equal:
        divergence = lockstep_threshold(
            torch, params, cfg, spec, prompts,
            [("approx-interval", KF, 1), ("none", KF, 1)])
        _judge("interval_cache R=1 vs fast_dllm", divergence)
    rec["cross_checks"]["interval_cache R=1 == fast_dllm"] = {
        "equal": equal, "divergence": divergence,
        "calls": [r1.n_model_calls, fast.n_model_calls]}
    # (c) ar against the full-recompute greedy loop
    want = greedy_full_recompute(torch, params, cfg, prompts, BASELINE_GEN)
    got = runs["ar"].tokens
    divergence = ar_divergence(torch, params, cfg, got, want, PATHS_P)
    if divergence is not None:
        _judge("ar vs full-recompute greedy", divergence)
    rec["cross_checks"]["ar == full-recompute greedy"] = {
        "equal": divergence is None, "divergence": divergence}
    log(json.dumps(rec))
    return rec


def phase_baselines(torch, dev, ctx):
    """Phase 7: (a) the six decoders served at full width, (b) the four
    baselines' kernel paths against their plain paths, (c) the
    cross-checks.
    Returns the launches of (a), the main-path runs."""
    t = time.perf_counter()
    _, launches = check_baseline_serving(torch, dev, ctx)
    log(f"phase 7a (decoder serving): {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    check_baseline_paths(torch, dev, ctx)
    log(f"phase 7b-c (kernel vs plain, cross-checks): "
        f"{time.perf_counter() - t:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 8: tuning and benches
# ---------------------------------------------------------------------------
SERVING_BENCH_REQUESTS = 16      # bench_serving_torch part (a) runs 48


def main_path_candidates(torch, dev):
    """(op, case, shape, dtype, config) of every config ``run_sweep`` would
    try at the main path's shapes, fp32 too (its own rule's candidates),
    and of every entry of the cuda table for this card at its own shape."""
    from repro_torch.kernels import tuning
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = []
    for name, kv, g, hd in tuning.DECODE_SHAPES:
        for bq in tuning.DECODE_BQ:
            shape = dict(Kv=kv, rows=bq * g)
            for cfg in tuning.candidates("decode_attn", **shape):
                out.append(("decode_attn", f"{name} Bq={bq}",
                            dict(name=name, Kv=kv, G=g, hd=hd, Bq=bq),
                            "bfloat16", cfg))
            out.append(("decode_attn", f"{name} Bq={bq}",
                        dict(name=name, Kv=kv, G=g, hd=hd, Bq=bq),
                        "float32", None))
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        sel = dict(T=tuning.SELECT_SHAPE["T"], V=151_936, n_sms=n_sms,
                   dtype=dt)
        for cfg in tuning.candidates("select", **sel):
            out.append(("select", "qwen2-0.5b", dict(
                T=sel["T"], d=tuning.SELECT_SHAPE["d"], V=sel["V"]), dtype,
                cfg))
        for T in tuning.XENT_TS:
            xs = dict(T=T, V=tuning.XENT_SHAPE["V"], n_sms=n_sms, dtype=dt)
            for cfg in tuning.candidates("xent", **xs):
                out.append(("xent", f"qwen2-0.5b T={T}", dict(
                    T=T, d=tuning.XENT_SHAPE["d"], V=xs["V"]), dtype, cfg))
    here = tuning.backend(dev)
    for (op, bucket, backend), e in sorted(tuning._load().items()):
        if backend != here:
            continue
        cfg = tuning.KernelConfig.from_dict(e["config"])
        sh = e["shape"]
        if op == "decode_attn":
            out.append((op, f"table {bucket}", dict(
                name=bucket, Kv=sh["Kv"], G=sh["G"], hd=sh["hd"],
                Bq=sh["Bq"]), "bfloat16", cfg))
        else:
            out.append((op, f"table {bucket}", dict(T=sh["T"], d=sh["d"],
                                                   V=sh["V"]), "bfloat16",
                        cfg))
    return out


def check_candidates(torch, dev):
    """(a) Every candidate and table config against the plain version:
    decode attention (dense and paged) within 1e-4 and dense == paged bit
    for bit under each split, select within ``select_limits``, xent's loss
    within 1e-4 and its gradients within ``grad_limit``."""
    from repro_torch.kernels import tuning
    cases = main_path_candidates(torch, dev)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n = {}
    for op, case, sh, dtype, cfg in cases:
        knobs = cfg.to_dict() if cfg is not None else "fp32 route"
        name = f"tuning {op} {case} {dtype} {knobs}"
        if case.startswith("table"):
            # the entry through the wrappers' own resolution, no config=
            shape = (dict(Kv=sh["Kv"], rows=sh["Bq"] * sh["G"])
                     if op == "decode_attn" else
                     dict(T=sh["T"], V=sh["V"], n_sms=n_sms,
                          dtype=torch.bfloat16))
            got = tuning.resolve(op, backend_name=tuning.backend(dev),
                                 **shape).to_dict()
            if {k: got[k] for k in knobs} != knobs:
                raise AssertionError(f"{name}: resolved {got}")
            cfg = None
        if op == "decode_attn":
            S = 768 if sh["Bq"] > 1 else 576
            lens = ([0, 512, 536, 577, 608, 640, 700, 736] if sh["Bq"] > 1
                    else [512, 513, 527, 544, 559, 560, 574, 575])
            check_paged(torch, dev, b=8, Bq=sh["Bq"], Kv=sh["Kv"], G=sh["G"],
                        hd=sh["hd"], S=S, lens=lens, dtype=dtype, name=name,
                        config=cfg)
        elif op == "select":
            check_select(torch, dev, T=sh["T"], d=sh["d"], V=sh["V"],
                         dtype=dtype, scale=0.02, name=name, config=cfg)
        else:
            check_xent(torch, dev, T=sh["T"], d=sh["d"], V=sh["V"],
                       dtype=dtype, name=name, config=cfg)
        n[op] = n.get(op, 0) + 1
    return n


def check_graph_under_splits(torch, dev, ctx):
    """(a) Graph == eager for the refinement iterations of one block (8
    one-block requests of phase 3's trace) under the table's split and
    under every other candidate split of qwen2-0.5b's bucket, each put in a
    table of its own for the run: tokens, steps, calls and launches
    equal."""
    import tempfile

    from repro_torch.kernels import tuning
    from repro_torch.serving import ContinuousEngine, Request
    cfg, P, B = ctx["cfg"], ctx["P"], ctx["B"]
    Kv, rows = cfg.n_kv_heads, B * cfg.q_per_kv
    table_split = tuning.resolve("decode_attn", backend_name=tuning.backend(
        dev), Kv=Kv, rows=rows).tiles_per_split
    reqs = [Request(prompt=ctx["prompts"][i], id=i, max_tokens=B)
            for i in range(8)]
    splits = [None] + [c.tiles_per_split for c in tuning.candidates(
        "decode_attn", Kv=Kv, rows=rows) if c.tiles_per_split != table_split]
    results = {}
    saved = tuning.TABLE_PATH
    with tempfile.TemporaryDirectory() as tmp:
        try:
            for split in splits:
                if split is not None:
                    tuning.TABLE_PATH = Path(tmp) / f"split{split}.json"
                    tuning.save_table([{
                        "op": "decode_attn", "backend": tuning.backend(dev),
                        "bucket": tuning.bucket_for("decode_attn", Kv=Kv,
                                                    rows=rows),
                        "config": {"tiles_per_split": split}}])
                tuning.clear_cache()
                got = tuning.resolve("decode_attn",
                                     backend_name=tuning.backend(dev), Kv=Kv,
                                     rows=rows).tiles_per_split
                want = table_split if split is None else split
                if got != want:
                    raise AssertionError(f"split {want} resolved as {got}")
                runs = {}
                for name, graphs in (("eager", False), ("graph", None)):
                    eng = ContinuousEngine(ctx["params"], cfg, ctx["serve"],
                                           prompt_len=P, device=dev,
                                           graphs=graphs)
                    eng.warmup()
                    outs, _, counts = serve_counted(torch, dev, eng, reqs)
                    check_launches(cfg, eng.call_counts(), counts, "dense")
                    runs[name] = ({rid: (o.tokens.tolist(), o.steps)
                                   for rid, o in outs.items()},
                                  eng.call_counts(), counts)
                if runs["eager"] != runs["graph"]:
                    raise AssertionError(f"graph != eager under split {want}")
                results[f"{'table' if split is None else 'candidate'} "
                        f"split {want}"] = {
                    "equal": True, "calls": runs["graph"][1],
                    "mean_steps": float(np.mean(
                        [v[1] for v in runs["graph"][0].values()]))}
        finally:
            tuning.TABLE_PATH = saved
            tuning.clear_cache()
    return results


def phase_tuning_and_benches(torch, dev, ctx):
    """Phase 8: (a) the cuda table and every candidate held against the
    plain versions, graph == eager under each split; (b) the serving bench's
    part (a) at a cut depth, its launches counted; (c) the H100 roofline
    constants against the peaks every bound uses. Returns (b)'s
    launches."""
    from repro_torch.configs import H100
    from repro_torch.kernels import tuning
    from repro_torch.roofline import LLADA_8B, attainable_tflops, \
        blockwise_dlm_ai
    t = time.perf_counter()
    tuning.clear_cache()
    table = {f"{k[0]} {k[1]}": e["config"]
             for k, e in tuning._load().items()
             if k[2] == tuning.backend(dev)}
    counts = check_candidates(torch, dev)
    graph = check_graph_under_splits(torch, dev, ctx)
    log(json.dumps({"phase": "tuning", "backend": tuning.backend(dev),
                    "table": table or "empty: every op on its built-in rule",
                    "configs_checked": counts,
                    "graph_equals_eager": graph}))
    log(f"phase 8a (tuning table and candidates): "
        f"{time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    sys.path.insert(0, str(ROOT))
    from benchmarks import bench_serving_torch as bench
    records = []
    log(f"phase 8b: bench_serving_torch part (a) with "
        f"{SERVING_BENCH_REQUESTS} requests in the scheduler trace (cut "
        f"from {bench.FULL['requests']}) and "
        f"{max(8, SERVING_BENCH_REQUESTS * 2 // 3)} in the layouts' (cut "
        f"from {max(8, bench.FULL['requests'] * 2 // 3)}); widths, lanes, "
        "pools and the preemption case as in the bench; the static "
        "engine through its graphs only (phases 6c and 7a hold it to "
        "its eager path)")
    zero_counts()
    res = bench.run_full(dev, records, n_requests=SERVING_BENCH_REQUESTS,
                         eager_static=False)
    torch.cuda.synchronize(dev)
    launches = read_counts()
    for name in ("decode_attention", "paged_decode_attention",
                 "fused_select", "block_attention"):
        if not launches[name]:
            raise AssertionError(f"serving bench: {name} never launched")
    log(json.dumps({"phase": "serving bench", "launches": launches,
                    "results": bench._summary(res)}))
    log(json.dumps({"serving_bench_records": records}))
    log(f"phase 8b (serving bench): {time.perf_counter() - t:.1f} s")

    # every bound reads the H100 config: one copy of the card's peaks
    one_ms = (bound_ms(H100.hbm_bw * 1e-3, 0, "bfloat16")[0],
              bound_ms(0, H100.peak_flops * 1e-3, "bfloat16")[0])
    if not all(abs(x - 1.0) < 1e-9 for x in one_ms):
        raise AssertionError(f"the bounds' peaks differ from the H100 "
                             f"config: {one_ms}")
    log(json.dumps({"phase": "roofline", "card": H100.name,
                    "peak_flops": H100.peak_flops, "hbm_bw": H100.hbm_bw,
                    "ridge_ai": H100.ridge_ai,
                    "block32_llada_attainable_tflops": {
                        bs: attainable_tflops(blockwise_dlm_ai(
                            LLADA_8B, bs, 32), H100) for bs in (1, 128)}}))
    return launches


# ---------------------------------------------------------------------------
# phase 9: other architectures on the main path
# ---------------------------------------------------------------------------
def static_ar(torch, dev, cfg, params, name):
    """Phase 9's static ``ar`` run: ``AR_RUN``'s lanes of a prompt, through
    the static ``Engine`` eagerly and through its CUDA graphs in turns
    (eager, graph, graph, eager): tokens, steps, generation lengths and
    calls equal, the launches equal on both paths and to the accounting
    (per batch: the causal prefill's block attention and every step's
    decode attention once per attention layer, no select). Returns
    (record, the graph runs' decode launches)."""
    import gc

    from repro_torch.configs import ServeConfig
    from repro_torch.serving import Engine, Request
    b, P, G = AR_RUN
    serve = ServeConfig(max_batch=b, block_size=32, gen_length=G,
                        scheduler="static", sampler="ar", fused_select=True)
    prompts = np.random.default_rng(11).integers(0, cfg.mask_token_id,
                                                 (b, P))
    reqs = [Request(prompt=p, id=i) for i, p in enumerate(prompts)]
    engines = {}
    for graphs in (False, None):
        engines[graphs] = Engine(params, cfg, serve, prompt_len=P,
                                 device=dev, graphs=graphs)
        engines[graphs].warmup()
    n_attn = attention_layers(cfg)
    want = {k: 0 for k in kernel_counters()}
    want.update(decode_attention=n_attn * G, block_attention=n_attn,
                **elementwise_launches(cfg, 1 + G))
    runs, rec, graph_decode = [], {}, 0
    for graphs in (False, None, None, False):
        path = "graph" if graphs is None else "eager"
        outs, wall, launches = serve_counted(torch, dev, engines[graphs],
                                             reqs)
        calls = engines[graphs].call_counts()
        if launches != want or calls != {"batches": 1, "total": 1 + G}:
            raise AssertionError(f"{name} ar ({path}): launches {launches}"
                                 f" / calls {calls} != {want}")
        runs.append({i: (o.tokens.tolist(), o.steps, o.gen_length)
                     for i, o in outs.items()})
        # every lane decodes G tokens (ar runs its whole grid, EOS or not)
        rec.setdefault(f"{path}_decoded_tps", []).append(b * G / wall)
        rec.setdefault(f"{path}_gen_tokens", []).append(
            sum(o.gen_length for o in outs.values()))
        if graphs is None:
            graph_decode += launches["decode_attention"]
    if any(r != runs[0] for r in runs[1:]):
        raise AssertionError(f"{name}: ar through the graphs differs from "
                             "eager")
    rec.update(calls=1 + G, launches_per_run=want, graph_equals_eager=True)
    del engines
    gc.collect()
    return rec, graph_decode


def serve_architecture(torch, dev, name, depth, smi):
    """One config of ``ARCH_RUNS`` through ``ContinuousEngine``, dense then
    paged (an attention-free config: dense, and the paged layout's refusal
    asserted), a profiled block of one-block requests through the dense
    engine's graphs, and for a ``SHAPE_KEYED`` config the static ``ar`` run
    (``static_ar``); returns (record, launches by summary key summed over
    the config's runs)."""
    import dataclasses
    import gc

    from repro_torch.bridge import param_count
    from repro_torch.configs import ServeConfig, get_config
    from repro_torch.serving import ContinuousEngine, Request

    P, B, G = 128, 32, 64
    caps = [64, 32, 64, 32, 64, 32, 64, 32]
    cfg = get_config(name)
    if depth is not None:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    params = _random_params(torch, cfg, dev, "bfloat16")
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t
    n_params = param_count(params)
    prompts = np.random.default_rng(9).integers(0, cfg.mask_token_id,
                                                (len(caps), P))
    layouts = ("dense",) if cfg.is_attention_free else ("dense", "paged")
    runs, total, profile = {}, None, None
    for layout in ("dense", "paged"):
        serve = ServeConfig(max_batch=8, block_size=B, gen_length=G,
                            conf_threshold=0.9, scheduler="continuous",
                            fused_select=True, cache_layout=layout)
        if layout not in layouts:
            try:
                ContinuousEngine(params, cfg, serve, prompt_len=P,
                                 device=dev)
            except ValueError as e:
                if "paged layout needs attention KV" not in str(e):
                    raise
                runs["paged_refused"] = str(e)
                continue
            raise AssertionError(f"{name}: the paged layout was not refused")
        eng = ContinuousEngine(params, cfg, serve, prompt_len=P, device=dev)
        t = time.perf_counter()
        eng.warmup()
        warm_s = time.perf_counter() - t
        if not eng._graphs:
            raise AssertionError(f"{name}: the engine captured no graph")
        reqs = [Request(prompt=p, id=i, max_tokens=c)
                for i, (p, c) in enumerate(zip(prompts, caps))]
        outs, wall, launches = serve_counted(torch, dev, eng, reqs)
        calls = eng.call_counts()
        check_outputs(cfg, outs, dict(enumerate(caps)), B)
        check_launches(cfg, calls, launches, layout)
        for rid, o in outs.items():
            if not ((o.tokens >= 0) & (o.tokens < cfg.vocab_size)).all():
                raise AssertionError(f"{name} {layout} request {rid}: a "
                                     "token outside the vocabulary")
        tokens = sum(o.gen_length for o in outs.values())
        runs[layout] = {"outs": outs, "rec": {
            "tokens": tokens, "wall_s": wall, "tps": tokens / wall,
            "warmup_s": warm_s,
            "mean_steps": float(np.mean([o.steps for o in outs.values()])),
            "calls": calls, "launches": launches}}
        total = (launches if total is None else
                 {k: total[k] + launches[k] for k in total})
        if layout == "dense":
            # where the time goes: a block of one-block requests through
            # the graphs (after the counted run: its launches are not the
            # main path's)
            profile = profile_block(torch, dev, eng, prompts, B,
                                    recurrent=True)
            iters = profile["calls"]["refine"]
            profile["device_ms_per_iteration"] = (
                profile["device_busy_ms"] / max(iters, 1))
            log(json.dumps(dict(profile, config=name, card=smi)))
        del eng
        gc.collect()
    dense = runs["dense"]["outs"]
    if "paged" in runs:
        paged = runs["paged"]["outs"]
        for rid, o in dense.items():
            p = paged[rid]
            if not (np.array_equal(o.tokens, p.tokens)
                    and (o.steps, o.gen_length) == (p.steps, p.gen_length)):
                raise AssertionError(f"{name} request {rid}: paged tokens "
                                     "differ from dense")
    launches = {arch_key(k, name): total[k] for k in ARCH_KERNELS}
    if cfg.moe_dispatch == "grouped":
        # the grouped MoE's and the QK-norm pass's summary entries: their
        # launches on this config's served runs
        launches["grouped_moe"] = total["moe_gate_up"]
        launches["qkv_rope_qk_norm"] = total["qkv_rope"]
    ar = None
    if name in SHAPE_KEYED:
        ar, ar_decode = static_ar(torch, dev, cfg, params, name)
        if attention_layers(cfg):
            launches[arch_key("decode_attention", name, Bq=1)] = ar_decode
    if cfg.is_attention_free:
        launches = {k: v for k, v in launches.items()
                    if k.startswith("fused_select")}
    rec = {"phase": "architecture serving", "config": name,
           "layers": cfg.n_layers, "d_model": cfg.d_model,
           "head_dim": cfg.head_dim, "params": n_params, "dtype": "bfloat16",
           "requests": len(caps), "max_batch": 8, "block": B, "gen": G,
           "prompt_len": P, "tau": 0.9, "init_s": init_s,
           "dense": runs["dense"]["rec"],
           "paged": runs["paged"]["rec"] if "paged" in runs else None,
           "paged_refused": runs.get("paged_refused"),
           "paged_equals_dense": "paged" in runs,
           "profile_groups_ms": profile["device_ms_by_group"],
           "profile_idle_share": profile["idle_share"],
           "static_ar": ar,
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(dev),
           "card": smi}
    log(json.dumps(rec))
    del params, dense, runs
    gc.collect()
    torch.cuda.empty_cache()
    return rec, launches


def phase_architectures(torch, dev, smi):
    """Each config of ``ARCH_RUNS`` in turn; returns the launches of each
    summary entry (``arch_key``: "decode_attention gemma-7b", ...) over
    the config's main-path runs."""
    launches = {}
    for name, depth in ARCH_RUNS:
        t = time.perf_counter()
        _, got = serve_architecture(torch, dev, name, depth, smi)
        if not all(v > 0 for v in got.values()):
            raise AssertionError(f"{name}: a kernel never launched {got}")
        launches.update(got)
        log(f"phase 9 ({name}): {time.perf_counter() - t:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 10: request extras (whisper-base, internvl2-1b) and the long window
# ---------------------------------------------------------------------------
EXTRAS_WHISPER = (8, 128, 64, 32)      # lanes, prompt, generation, block
EXTRAS_VLM = (8, 512, 64, 32)
EXTRAS_WINDOW = (4, 8192, 64, 32)
EXTRAS_LOSS = (2, 128, 64, 32)
WHISPER, VLM = "whisper-base", "internvl2-1b"
# phase 10's summary entries: the key of each, and the kernel it names
EXTRAS_KEYS = {
    f"decode_attention {WHISPER}": "decode_attention",
    f"block_attention {WHISPER}": "block_attention",
    f"fused_select {WHISPER}": "fused_select",
    f"xent_forward {WHISPER}": "xent_forward",
    f"xent_backward {WHISPER}": "xent_backward",
    f"decode_attention {VLM}": "decode_attention",
    f"paged_decode_attention {VLM}": "paged_decode_attention",
    f"block_attention {VLM}": "block_attention",
    f"fused_select {VLM}": "fused_select",
    f"decode_attention {VLM} window8192": "decode_attention",
    f"block_attention {VLM} L8448": "block_attention",
}


def check_extras_kernels(torch, dev):
    """Phase 2's cases at phase 10's shapes, bf16, each timed against its
    plain version and one library call, with its bound; returns the
    records by ``EXTRAS_KEYS``. whisper-base: the decoder's self attention
    (Kv 8, G 1, hd 64: 32 folded rows) at 8 lanes of a 192-row cache, the
    encoder's bidirectional block attention at 8 lanes of its 1,500 ragged
    frames (and the decoder's 128-token prefill, checked), the select over
    its (51,865, 512) head, the cross-entropy at phase 10d's 128 rows;
    internvl2-1b (qwen2's attention layout): decode and paged decode at 8
    lanes of an 832-row cache (256 prefix rows + P 512 + G 64), the
    prefill at L 768, the select over its untied (151,655, 896) head; the
    long window: decode with window 8,192 at 4 lanes of an 8,512-row cache
    (blocks at 8,448 and 8,480) and the prefill at L 8,448 (one lane: the
    plain version's fp32 scores at four would take 16 GB a tensor), the
    main path's (no window: the reference's prefill takes none) timed and
    the windowed one checked and timed too."""
    main = {}
    kw = dict(dtype="bfloat16", timed=True)
    _, P, G, _ = EXTRAS_WHISPER
    main[f"decode_attention {WHISPER}"] = check_decode(
        torch, dev, b=8, Bq=32, Kv=8, G=1, hd=64, S=P + G,
        lens=[P, P + 32] * 4, name=f"{WHISPER} decode", **kw)
    main[f"block_attention {WHISPER}"] = check_block(
        torch, dev, b=8, L=1500, Kv=8, G=1, hd=64, mode="bidirectional",
        name=f"{WHISPER} encoder L=1500", **kw)
    check_block(torch, dev, b=8, L=P, Kv=8, G=1, hd=64, dtype="bfloat16",
                mode="block_causal", prompt_len=P, block_size=32,
                name=f"{WHISPER} decoder prefill")
    main[f"fused_select {WHISPER}"] = check_select(
        torch, dev, T=256, d=512, V=51_865, scale=0.02,
        name=f"{WHISPER} unembed", **kw)
    b, P, G, _ = EXTRAS_LOSS
    xent = check_xent(torch, dev, T=b * G, d=512, V=51_865,
                      name=f"{WHISPER} DLM term", **kw)
    main[f"xent_forward {WHISPER}"] = dict(xent["forward"],
                                           max_abs_err=xent["max_abs_err"])
    main[f"xent_backward {WHISPER}"] = dict(
        xent["backward"], max_abs_err=max(xent["dh_max_abs_err"],
                                          xent["dw_max_abs_err"]))
    _, P, G, _ = EXTRAS_VLM
    S = 256 + P + G
    lens = [256 + P, 256 + P + 32] * 4
    main[f"decode_attention {VLM}"] = check_decode(
        torch, dev, b=8, Bq=32, Kv=2, G=7, hd=64, S=S, lens=lens,
        name=f"{VLM} decode", **kw)
    main[f"paged_decode_attention {VLM}"] = check_paged(
        torch, dev, b=8, Bq=32, Kv=2, G=7, hd=64, S=S, lens=lens,
        name=f"{VLM} decode", **kw)
    main[f"block_attention {VLM}"] = check_block(
        torch, dev, b=8, L=256 + P, Kv=2, G=7, hd=64, mode="block_causal",
        prompt_len=256 + P, block_size=32, name=f"{VLM} prefill L=768", **kw)
    main[f"fused_select {VLM}"] = check_select(
        torch, dev, T=256, d=896, V=151_655, scale=0.02,
        name=f"{VLM} unembed", **kw)
    b, P, G, _ = EXTRAS_WINDOW
    L = 256 + P
    main[f"decode_attention {VLM} window8192"] = check_decode(
        torch, dev, b=b, Bq=32, Kv=2, G=7, hd=64, S=L + G,
        lens=[L, L + 32] * (b // 2), window=8192,
        name=f"{VLM} decode window 8192", **kw)
    main[f"block_attention {VLM} L8448"] = check_block(
        torch, dev, b=1, L=L, Kv=2, G=7, hd=64, mode="block_causal",
        prompt_len=L, block_size=32, name=f"{VLM} prefill L=8448", **kw)
    rec = check_block(torch, dev, b=1, L=L, Kv=2, G=7, hd=64,
                      mode="block_causal", prompt_len=P, block_size=32,
                      window=8192, name=f"{VLM} window 8192 L=8448", **kw)
    main[f"block_attention {VLM} L8448"]["windowed_case"] = {
        k: rec.get(k) for k in ("max_abs_err", "kernel_ms", "plain_ms",
                                "library_ms", "bound_ms", "bound_by",
                                "kernel_device_ms")}
    return main


def extras_rows(torch, cfg, n, seed, prefix=0):
    """``n`` requests' extras, 0.1 N(0, 1) from ``seed`` rounded to bf16
    (held as fp32, which the engine's buffers keep): whisper's frames
    (encoder_seq_len, d), or ``prefix`` rows of patch embeddings."""
    rng = np.random.default_rng(seed)
    key, rows = (("encoder_embeds", cfg.encoder_seq_len)
                 if cfg.is_encoder_decoder else ("prefix_embeds", prefix))
    x = 0.1 * rng.standard_normal((n, rows, cfg.d_model)).astype(np.float32)
    x = torch.from_numpy(x).bfloat16().float().numpy()
    return [{key: x[i]} for i in range(n)]


def _add(total, counts, key_of):
    for kernel, n in counts.items():
        key = key_of.get(kernel)
        if key is not None:
            total[key] = total.get(key, 0) + n


def attribute_encoder(torch, dev, eng, reqs):
    """Device ms of whisper's encoder and of its cross-attention sublayers
    in one eager ``cdlm`` batch of ``reqs``: ``models.transformer.encode``
    and ``_cross_attention_slot`` wrapped in profiler ranges for that
    batch (restored after), each range's device time the kernels launched
    inside it (the CPU range's ``FunctionEvent.device_time_total``; the
    range's device-side annotation, a span, is not counted). A graph
    replay has no ranges, so this reads the eager engine; the kernels'
    time does not depend on the path."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.models import transformer as TT
    real = {"encode": TT.encode,
            "_cross_attention_slot": TT._cross_attention_slot}

    def ranged(label, fn):
        def wrapper(*a, **kw):
            with record_function(label):
                return fn(*a, **kw)
        return wrapper

    TT.encode = ranged("phase10.encoder", real["encode"])
    TT._cross_attention_slot = ranged("phase10.cross_attention",
                                      real["_cross_attention_slot"])
    try:
        eng.generate(reqs)           # warm
        torch.cuda.synchronize(dev)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            eng.generate(reqs)
            torch.cuda.synchronize(dev)
    finally:
        TT.encode = real["encode"]
        TT._cross_attention_slot = real["_cross_attention_slot"]
    out = {"encoder_ms": 0.0, "cross_attention_ms": 0.0,
           "encoder_calls": 0, "cross_attention_calls": 0}
    for ev in prof.events():
        if ev.device_type != DeviceType.CPU:
            continue
        for label, key in (("phase10.encoder", "encoder"),
                           ("phase10.cross_attention", "cross_attention")):
            if ev.name == label:
                out[f"{key}_ms"] += ev.device_time_total / 1e3
                out[f"{key}_calls"] += 1
    out["calls"] = eng.call_counts()
    return out


def phase_extras_whisper(torch, dev, smi):
    """(a) whisper-base at full depth through the static ``Engine``: the
    six decoders (``cdlm`` first), each eagerly and through its graphs in
    turns (``static_ab``: tokens, steps, calls and launches equal, the
    launches held to each decoder's accounting, the encoder's layers in
    every full-sequence forward), tokens/s of each; ``cdlm``'s profiled
    batch (graph and eager), the encoder's and the cross attention's
    device ms from an eager batch under ranges; the continuous engine's
    and the paged layout's refusals. Returns the launches by summary
    key."""
    import gc

    from repro_torch.bridge import param_count
    from repro_torch.configs import ServeConfig, get_config
    from repro_torch.core import cache as C
    from repro_torch.serving import ContinuousEngine, Engine, Request
    cfg = get_config(WHISPER)
    b, P, G, B = EXTRAS_WHISPER
    params = _random_params(torch, cfg, dev, "bfloat16")
    prompts = np.random.default_rng(21).integers(0, cfg.mask_token_id,
                                                 (b, P))
    ex = extras_rows(torch, cfg, b, 22)
    ctx = {"cfg": cfg, "params": params, "P": P, "B": B, "prompts": prompts,
           "extras": ex}
    reqs = [Request(prompt=prompts[i], id=i, extras=ex[i]) for i in range(b)]
    key_of = {k: f"{k} {WHISPER}" for k in ("decode_attention",
                                            "block_attention",
                                            "fused_select")}
    total, recs = {}, []
    for name in ("cdlm",) + tuple(d for d in DECODERS if d != "cdlm"):
        serve = ServeConfig(max_batch=b, block_size=B, gen_length=G,
                            conf_threshold=0.9, scheduler="static",
                            sampler=name, fused_select=True)
        rec, counts = static_ab(torch, dev, ctx, name, serve, reqs,
                                profile=name == "cdlm")
        recs.append(rec)
        _add(total, counts, key_of)
    serve = ServeConfig(max_batch=b, block_size=B, gen_length=G,
                        conf_threshold=0.9, scheduler="static",
                        sampler="cdlm", fused_select=True)
    eng = Engine(params, cfg, serve, prompt_len=P, device=dev, graphs=False)
    # the profiled batch's requests (one block each, profile_block's)
    shares = attribute_encoder(torch, dev, eng, [
        Request(prompt=prompts[i], id=1000 + i, max_tokens=B, extras=ex[i])
        for i in range(b)])
    del eng
    refusals = {}
    try:
        ContinuousEngine(params, cfg, serve, prompt_len=P, device=dev)
        raise AssertionError("whisper: the continuous engine was not "
                             "refused")
    except ValueError as e:
        if "does not support encoder-decoder models yet" not in str(e):
            raise
        refusals["continuous"] = str(e)
    try:
        C.init_paged_cache(cfg, b, P + G, n_pages=8, page_size=B,
                           device=dev)
        raise AssertionError("whisper: the paged layout was not refused")
    except ValueError as e:
        if "paged layout does not support encoder-decoder" not in str(e):
            raise
        refusals["paged"] = str(e)
    log(json.dumps({"phase": "extras serving", "config": WHISPER,
                    "params": param_count(params), "dtype": "bfloat16",
                    "engine": "static, eager and graphs", "requests": b,
                    "prompt_len": P, "gen": G, "block": B, "tau": 0.9,
                    "encoder_frames": cfg.encoder_seq_len,
                    "decoders": recs, "cdlm_eager_attribution": shares,
                    "refusals": refusals, "card": smi}))
    del params, ctx
    gc.collect()
    torch.cuda.empty_cache()
    return total


def phase_extras_vlm(torch, dev, smi):
    """(b) internvl2-1b at full depth with 256 prefix rows through the
    static ``Engine``: ``cdlm`` greedy fused on the dense then the paged
    layout, each eagerly and through its graphs in turns (``static_ab``),
    paged tokens equal to dense. (c) the long window: 4 lanes of P 8,192
    after the 256 prefix rows, ``use_long_window`` (every block past the
    8,192-token window), through the static engine eagerly and through
    its graphs in turns, then ``ContinuousEngine`` on the same prompts
    without the prefix through its graphs and eagerly, tokens equal, its
    launches held to its call accounting. Returns the launches by summary
    key."""
    import gc

    from repro_torch.configs import ServeConfig, get_config
    from repro_torch.serving import ContinuousEngine, Request
    cfg = get_config(VLM)
    off = cfg.n_prefix_embeds
    params = _random_params(torch, cfg, dev, "bfloat16")
    total, recs = {}, {}
    b, P, G, B = EXTRAS_VLM
    prompts = np.random.default_rng(31).integers(0, cfg.mask_token_id,
                                                 (b, P))
    ex = extras_rows(torch, cfg, b, 32, prefix=off)
    ctx = {"cfg": cfg, "params": params, "P": P, "B": B, "prompts": prompts,
           "extras": ex, "pos_offset": off}
    reqs = [Request(prompt=prompts[i], id=i, extras=ex[i]) for i in range(b)]
    outs = {}
    for layout in ("dense", "paged"):
        serve = ServeConfig(max_batch=b, block_size=B, gen_length=G,
                            conf_threshold=0.9, scheduler="static",
                            sampler="cdlm", fused_select=True,
                            cache_layout=layout)
        got = []
        recs[layout], counts = static_ab(torch, dev, ctx, "cdlm", serve,
                                         reqs, outputs=got)
        outs[layout] = got[0]
        _add(total, counts, {
            "decode_attention": f"decode_attention {VLM}",
            "paged_decode_attention": f"paged_decode_attention {VLM}",
            "block_attention": f"block_attention {VLM}",
            "fused_select": f"fused_select {VLM}"})
    if outs["paged"] != outs["dense"]:
        raise AssertionError(f"{VLM}: paged tokens differ from dense")

    b, P, G, B = EXTRAS_WINDOW
    prompts = np.random.default_rng(33).integers(0, cfg.mask_token_id,
                                                 (b, P))
    ex = extras_rows(torch, cfg, b, 34, prefix=off)
    ctx = {"cfg": cfg, "params": params, "P": P, "B": B, "prompts": prompts,
           "extras": ex, "pos_offset": off, "use_long_window": True}
    reqs = [Request(prompt=prompts[i], id=i, extras=ex[i]) for i in range(b)]
    serve = ServeConfig(max_batch=b, block_size=B, gen_length=G,
                        conf_threshold=0.9, scheduler="static",
                        sampler="cdlm", fused_select=True)
    recs["window static"], counts = static_ab(torch, dev, ctx, "cdlm",
                                              serve, reqs)
    _add(total, counts, {
        "decode_attention": f"decode_attention {VLM} window8192",
        "block_attention": f"block_attention {VLM} L8448",
        "fused_select": f"fused_select {VLM}"})
    serve = ServeConfig(max_batch=b, block_size=B, gen_length=G,
                        conf_threshold=0.9, scheduler="continuous",
                        fused_select=True)
    creqs = [Request(prompt=prompts[i], id=i) for i in range(b)]
    cont = {}
    for path, graphs in (("graph", None), ("eager", False)):
        eng = ContinuousEngine(params, cfg, serve, prompt_len=P,
                               use_long_window=True, device=dev,
                               graphs=graphs)
        eng.warmup()
        got, wall, launches = serve_counted(torch, dev, eng, creqs)
        calls = eng.call_counts()
        check_launches(cfg, calls, launches, "dense")
        check_outputs(cfg, got, {i: G for i in range(b)}, B)
        cont[path] = ({rid: (o.tokens.tolist(), o.steps, o.gen_length)
                       for rid, o in got.items()},
                      {"wall_s": wall, "tps": sum(
                          o.gen_length for o in got.values()) / wall,
                       "calls": calls, "launches": launches})
        if path == "graph":
            # the continuous engine's window decode: the same kernel and
            # window at a cache of P + G rows
            total[f"decode_attention {VLM} window8192"] += launches[
                "decode_attention"]
            total[f"fused_select {VLM}"] += launches["fused_select"]
        del eng
    if cont["graph"][0] != cont["eager"][0]:
        raise AssertionError(f"{VLM} long window: the continuous engine's "
                             "graph tokens differ from eager")
    recs["window continuous"] = {path: v[1] for path, v in cont.items()}
    log(json.dumps({"phase": "extras serving", "config": VLM,
                    "dtype": "bfloat16", "prefix_rows": off,
                    "runs": {"prefix": EXTRAS_VLM, "window": EXTRAS_WINDOW},
                    "paged_equals_dense": True, "records": recs,
                    "max_memory_allocated_bytes":
                        torch.cuda.max_memory_allocated(dev),
                    "card": smi}))
    del params, ctx
    gc.collect()
    torch.cuda.empty_cache()
    return total


def phase_extras_loss(torch, dev):
    """(d) one ``cdlm_loss`` evaluation with whisper's frames at full
    width (2 lanes, P 128, G 64, bf16): value and gradients (the encoder's
    three runs and the DLM term's fused cross-entropy forward and
    backward, launches counted), then that DLM term with the kernel and
    with the plain cross-entropy within phase 5's limits (losses rel 1e-4,
    ``grad_limit``). Returns the launches by summary key."""
    from repro_torch.configs import CDLMConfig, get_config
    from repro_torch.core import diffusion as D
    from repro_torch.core import losses as LS
    from repro_torch.kernels.xent import fused_xent
    from repro_torch.kernels.xent import ref as xref
    from repro_torch.models import forward
    from repro_torch.training import steps as S
    cfg = get_config(WHISPER)
    b, P, G, B = EXTRAS_LOSS
    params = _random_params(torch, cfg, dev, "bfloat16")
    rng = np.random.default_rng(41)

    def tok(*shape):
        return torch.as_tensor(rng.integers(2, cfg.mask_token_id, shape),
                               device=dev)

    u = np.zeros((b, P + G), bool)
    u[:, P + 3:P + 9] = True
    sm = np.zeros((b, P + G), bool)
    sm[:, P + 20:P + 40] = True
    batch = {"y": tok(b, P + G), "y_star": tok(b, P + G),
             "u_mask": torch.as_tensor(u, device=dev),
             "s_mask": torch.as_tensor(sm, device=dev),
             "teacher_hidden": 0.1 * torch.randn(
                 (b, G, cfg.d_model), device=dev,
                 generator=torch.Generator(device=dev).manual_seed(42)),
             "gt": tok(b, G), "prompt": tok(b, P)}
    ex = {"encoder_embeds": torch.as_tensor(np.stack([
        r["encoder_embeds"] for r in extras_rows(torch, cfg, b, 43)]),
        device=dev)}
    gen = torch.Generator(device=dev).manual_seed(44)
    draws = S.dlm_draws(gen, b, G, dev)
    cdlm = CDLMConfig(block_size=B, gen_length=G, prompt_length=P)
    head = {k: v.detach() for k, v in params["embed"].items()}
    zero_counts()
    (total, metrics), grads = S.value_and_grad(
        lambda p: S.cdlm_loss(p, None, batch, draws, cfg=cfg, cdlm=cdlm,
                              teacher_head=head, use_lora=False,
                              extras=ex), params)
    torch.cuda.synchronize(dev)
    launches = read_counts()
    _finite(torch, {"total": total, **metrics}, "whisper cdlm_loss")
    if not (launches["xent_forward"] >= 1 and launches["xent_backward"] >= 1):
        raise AssertionError(f"whisper cdlm_loss: launches {launches}")
    enc_g = grads["encoder"]["slots"][0]["attn"]["wq"].float().abs().max()
    if not enc_g > 0:
        raise AssertionError("whisper cdlm_loss: no gradient reached the "
                             "encoder")
    masked_gt, m = D.mask_tokens_from(draws["u"], batch["gt"], draws["t"],
                                      cfg.mask_token_id)
    with torch.no_grad():
        hid = forward(params, torch.cat([batch["prompt"], masked_gt], 1),
                      cfg=cfg, device=dev, mode="block_causal", prompt_len=P,
                      block_size=B, return_logits=False,
                      **ex).hidden[:, P:]
    plain_xent = lambda h, w, y: xref.xent_streaming(h, w, y)[0]  # noqa
    out = {}
    for name, fn in (("kernel", fused_xent), ("plain", plain_xent)):
        h = hid.clone().requires_grad_()
        w = params["embed"]["head"].clone().requires_grad_()
        loss = LS.dlm_loss_from_hidden(h, w, batch["gt"], m, draws["t"], fn)
        out[name] = (float(loss.detach()),
                     *torch.autograd.grad(loss, (h, w)))
    ok_h, err_h = grad_limit(torch, out["kernel"][1], out["plain"][1],
                             "bfloat16")
    ok_w, err_w = grad_limit(torch, out["kernel"][2], out["plain"][2],
                             "bfloat16")
    rel = {"dlm": abs(out["kernel"][0] - out["plain"][0])
           / abs(out["plain"][0]),
           "dlm_in_loss_vs_alone": abs(float(metrics["dlm"])
                                       - out["kernel"][0])
           / abs(out["kernel"][0])}
    if not (ok_h and ok_w and all(v <= 1e-4 for v in rel.values())):
        raise AssertionError(f"whisper DLM term: rel {rel}, dh {err_h} "
                             f"({ok_h}), dW {err_w} ({ok_w})")
    log(json.dumps({"phase": "extras loss", "config": WHISPER,
                    "dtype": "bfloat16", "batch": b, "prompt_len": P,
                    "gen": G, "loss": float(total),
                    "terms": {k: float(v) for k, v in metrics.items()},
                    "launches": launches, "kernel_vs_plain_rel": rel,
                    "dlm_dh_max_abs_err": err_h,
                    "dlm_dw_max_abs_err": err_w}))
    del params, grads
    torch.cuda.empty_cache()
    return {f"xent_forward {WHISPER}": launches["xent_forward"],
            f"xent_backward {WHISPER}": launches["xent_backward"]}


def phase_extras(torch, dev, smi):
    """Phase 10 (a)-(d); returns the launches of each ``EXTRAS_KEYS``
    entry over its runs, every one of them > 0."""
    launches = {}
    for label, run in (("a", lambda: phase_extras_whisper(torch, dev, smi)),
                       ("b, c", lambda: phase_extras_vlm(torch, dev, smi)),
                       ("d", lambda: phase_extras_loss(torch, dev))):
        t = time.perf_counter()
        launches.update(run())
        log(f"phase 10 ({label}): {time.perf_counter() - t:.1f} s")
    missing = {k: launches.get(k, 0) for k in EXTRAS_KEYS
               if not launches.get(k, 0) > 0}
    if missing:
        raise AssertionError(f"phase 10: kernels never launched {missing}")
    return launches


# phase 11: the parallel and dry-run layer
SEQ_RANKS = 4
SEQ_SHAPE = (8, 32, 2, 7, 64, 32768)    # b, Bq, Kv, G, hd, S: qwen2-0.5b's
# lengths on, below and across the 8,192-row shard edges
SEQ_LENS = (32768, 8192, 8191, 8193, 16400, 24576, 30001, 512)
SEQ_WINDOW = 4096
SEQ_ITERS = 20
ROOFLINE_RUN = ("qwen2-0.5b", "decode_32k", 10)   # arch, shape, steps
# budgets at which the toy models emit tokens before EOS (at 4-10 steps
# they emit EOS first, which would hide a decode that emits nothing)
EXAMPLE_RUNS = (
    ("quickstart_torch", ["--teacher-steps", "60", "--student-steps", "20",
                          "--examples", "64", "--eval", "32"]),
    ("train_cdlm_torch", ["--teacher-steps", "60", "--student-steps", "20",
                          "--examples", "32", "--eval", "16", "--lora"]),
    ("serve_blockwise_torch", ["--steps", "60", "--requests", "16",
                               "--batch", "8"]))
EXAMPLE_KERNELS = ("decode_attention", "fused_select", "block_attention",
                   "xent_forward", "xent_backward")


def _seq_inputs(torch, dev):
    b, Bq, Kv, G, hd, S = SEQ_SHAPE
    g = torch.Generator(device=dev).manual_seed(11)
    rnd = lambda *s: torch.randn(s, generator=g, device=dev).to(  # noqa
        torch.bfloat16)
    return (rnd(b, Bq, Kv, G, hd), rnd(b, S, Kv, hd), rnd(b, S, Kv, hd),
            rnd(b, Bq, Kv, hd), rnd(b, Bq, Kv, hd),
            torch.tensor(SEQ_LENS, dtype=torch.int32, device=dev))


def seq_decode_rank(rank, port, queue):
    """One of phase 11a's ranks: this rank's quarter of the cache through
    the sequence-parallel decode (gloo over CUDA tensors), timed; rank 0
    also runs the decode kernel over the whole cache and holds each output
    against it."""
    import torch
    import torch.distributed as dist

    from repro_torch.kernels.decode_attn import decode_attention
    from repro_torch.parallel import make_sharded_decode_attention
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=SEQ_RANKS)
    try:
        q, kc, vc, kb, vb, lens = _seq_inputs(torch, dev)
        n = kc.shape[1] // SEQ_RANKS
        kl = kc[:, rank * n:(rank + 1) * n].contiguous()
        vl = vc[:, rank * n:(rank + 1) * n].contiguous()
        fn = make_sharded_decode_attention(None, axis_size=SEQ_RANKS,
                                           axis_rank=rank)
        scale = SEQ_SHAPE[4] ** -0.5
        outs = {w: fn(q, kl, vl, kb, vb, lens, scale=scale, window=w)
                for w in (None, SEQ_WINDOW)}
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SEQ_ITERS):
            fn(q, kl, vl, kb, vb, lens, scale=scale)
        torch.cuda.synchronize()
        sharded_ms = (time.perf_counter() - t0) * 1e3 / SEQ_ITERS
        if rank == 0:
            cases = []
            for w, got in outs.items():
                want = decode_attention(q, kc, vc, kb, vb, lens, scale=scale,
                                        window=w)
                err = (got.float() - want).abs().max().item()
                # the result's bf16 rounding (half an ulp of the largest
                # value) plus the kernels' fp32 tolerance
                tol = 1e-4 + want.abs().max().item() * 2 ** -8
                cases.append({"window": w, "max_abs_err": err, "tol": tol,
                              "finite": bool(torch.isfinite(got).all()),
                              "shape": list(got.shape),
                              "dtype": str(got.dtype)})
            kernel_ms = time_ms(torch, lambda: decode_attention(
                q, kc, vc, kb, vb, lens, scale=scale), SEQ_ITERS)
            queue.put({"cases": cases, "sharded_ms": sharded_ms,
                       "kernel_ms": kernel_ms})
    finally:
        dist.destroy_process_group()


def phase_seq_decode(torch):
    """11a: four spawned ranks on the one card, gloo over CUDA tensors
    (NCCL refuses two ranks on one device), each holding a quarter of a
    cache at qwen2-0.5b's attention shape; the merged output held against
    the decode kernel over the whole cache, without and with a window."""
    import socket

    import torch.multiprocessing as mp
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    queue = mp.get_context("spawn").SimpleQueue()
    ranks = mp.start_processes(seq_decode_rank, args=(port, queue),
                               nprocs=SEQ_RANKS, join=False,
                               start_method="spawn")
    # drain the queue while joining (a rank that fails raises here)
    got = []
    while not ranks.join(timeout=1):
        while not queue.empty():
            got.append(queue.get())
    while not queue.empty():
        got.append(queue.get())
    if len(got) != 1:
        raise AssertionError(f"phase 11a: rank 0 reported {len(got)} times")
    res = got[0]
    b, Bq, Kv, G, hd, S = SEQ_SHAPE
    for case in res["cases"]:
        if not (case["finite"] and case["max_abs_err"] <= case["tol"]
                and case["shape"] == [b, Bq, Kv, G, hd]):
            raise AssertionError(f"phase 11a: sequence-parallel decode "
                                 f"against the decode kernel {case}")
    log(json.dumps({"seq_parallel_decode": dict(
        res, ranks=SEQ_RANKS, backend="gloo", lens=list(SEQ_LENS),
        shape=dict(b=b, Bq=Bq, Kv=Kv, G=G, hd=hd, S=S),
        note="4 ranks sharing one card (host-staged gloo merges): "
             "says nothing of 4 cards")}))


def phase_roofline(torch, dev, smi):
    """11b: the dry-run's plan of qwen2-0.5b x decode_32k at a 1x1 mesh,
    counted on meta (its three terms with the H100's constants), then the
    same step on the card: full width, cache filled in place with
    ``normal_`` in bf16, the decode through the kernel, the median of 10
    steps by CUDA events. Returns the step's kernel launches."""
    from repro_torch.bridge import init_params
    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.configs.base import H100
    from repro_torch.core import masks
    from repro_torch.core.cache import init_cache
    from repro_torch.kernels.decode_attn import decode_attention
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import forward

    arch, shape_name, steps = ROOFLINE_RUN
    cfg, shape = get_config(arch), INPUT_SHAPES[shape_name]
    rec = dryrun.run_one(arch, shape_name, mesh=Mesh(("data", "model"),
                                                     (1, 1)), verbose=False)
    S, b = shape.seq_len, shape.global_batch
    Bq = 32
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    # the cache and the fp32 logits a lane, with room for the step's
    # transients; a card without it cuts the batch only
    lane = (2 * cfg.n_layers * S * cfg.n_kv_heads * cfg.head_dim * 2
            + 2 * Bq * cfg.vocab_size * 4)
    free = torch.cuda.mem_get_info(dev)[0] - (4 << 30)
    run_b = b
    while run_b * lane > free:
        run_b //= 2
    if run_b != b:
        log(f"phase 11b: batch cut from {b} to {run_b} by the card's free "
            f"memory ({free / 2**30:.1f} GiB)")
    cache = init_cache(cfg, run_b, S, device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    for slot in cache:
        for leaf in slot.values():
            leaf.normal_(generator=g)
    tokens = torch.randint(0, cfg.vocab_size, (run_b, Bq), device=dev,
                           generator=g)
    lens = torch.full((run_b,), S, dtype=torch.int32, device=dev)

    def step():
        return forward(params, tokens, cfg=cfg, device=dev,
                       mode=masks.BLOCK_CAUSAL, block_size=Bq, cache=cache,
                       cache_len=lens, decode_attention_fn=decode_attention)

    with torch.no_grad():
        out = step()
        torch.cuda.synchronize()
        if not (out.logits.shape == (run_b, Bq, cfg.vocab_size)
                and bool(torch.isfinite(out.logits).all())):
            raise AssertionError("phase 11b: the step's logits "
                                 f"{tuple(out.logits.shape)} are not finite")
        del out
        zero_counts()
        ms = []
        for _ in range(steps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            step()
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
        launches = read_counts()
        # where the step's time goes: one step under the profiler
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
    groups, by_kernel = device_groups(prof)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:6]
    want = {"decode_attention": cfg.n_layers * steps}
    if {k: launches[k] for k in want} != want or any(
            v for k, v in launches.items() if k not in want):
        raise AssertionError(f"phase 11b: launches {launches}, want {want}")
    mem = rec["memory_analysis"]
    log(json.dumps({"roofline_vs_card": {
        "arch": arch, "shape": shape_name, "mesh": rec["mesh"],
        "batch": run_b, "counted_batch": b,
        "compute_ms": rec["compute_s"] * 1e3,
        "memory_ms": rec["memory_s"] * 1e3,
        "collective_ms": rec["collective_s"] * 1e3,
        "bottleneck": rec["bottleneck"],
        "arguments_once_ms": mem["argument_bytes"] / H100.hbm_bw * 1e3,
        "counted_flops": rec["hlo_flops"], "counted_bytes": rec["hlo_bytes"],
        "argument_bytes": mem["argument_bytes"],
        "measured_median_ms": float(np.median(ms)),
        "measured_ms": ms, "launches": launches,
        "profiled_step_device_ms_by_group": groups,
        "profiled_step_top_kernels": [[k, v[0], v[1]] for k, v in top],
        "card": smi}}))
    del params, cache, tokens
    torch.cuda.empty_cache()
    return launches


def phase_examples(torch):
    """11c: the three examples on the card at ``EXAMPLE_RUNS``' budgets,
    each run's kernel launches counted from 0; every kernel of
    ``EXAMPLE_KERNELS`` must launch, and every decode (the teacher's and
    the student's, every served row) must emit tokens before EOS."""
    import importlib.util
    total = {}
    for name, args in EXAMPLE_RUNS:
        spec = importlib.util.spec_from_file_location(
            name, ROOT / "examples" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        t = time.perf_counter()
        zero_counts()
        out = mod.main(["--device", "cuda"] + args)
        torch.cuda.synchronize()
        counts = read_counts()
        if isinstance(out, dict):
            gen = {k: out[k] for k in ("teacher_gen_length",
                                       "student_gen_length")}
        else:
            # a row that served fewer responses than requests counts 0
            want = int(args[args.index("--requests") + 1])
            gen = {f"{r['sampler']}/{r['scheduler']}":
                   r["gen_length"] if r["n"] == want else 0.0 for r in out}
        if len(gen) < 2 or not all(v > 0 for v in gen.values()):
            raise AssertionError(f"phase 11c: {name} emitted no tokens: "
                                 f"{gen} ({out!r})")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        log(json.dumps({"example": name, "args": args, "launches": counts,
                        "gen_length": gen, "s": time.perf_counter() - t}))
    missing = [k for k in EXAMPLE_KERNELS if not total.get(k)]
    if missing:
        raise AssertionError(f"phase 11c: kernels never launched {missing}")
    return total


def phase_parallel(torch, dev, smi):
    """Phase 11 (a)-(c)."""
    out = {}
    for label, run in (("a", lambda: phase_seq_decode(torch)),
                       ("b", lambda: phase_roofline(torch, dev, smi)),
                       ("c", lambda: phase_examples(torch))):
        t = time.perf_counter()
        out[label] = run()
        log(f"phase 11 ({label}): {time.perf_counter() - t:.1f} s")
    return out



def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build   # fails outside a checkout

    dev = torch.device("cuda", 0)
    t_all = time.perf_counter()
    t = time.perf_counter()
    smi = nvidia_smi()
    log(f"card: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    so = _build.build(verbose=True, force=True)   # ptxas' report, always
    log(json.dumps({"ptxas": ptxas_check(_build.PTXAS)}))
    log(json.dumps({"sass_hgmma": sass_hgmma(so)}))
    log(f"phase 1 (card, build): {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    main_recs = phase_kernels(torch, dev)
    log(f"phase 2 (kernels vs plain): {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    ctx = phase_serving(torch, dev)
    log(f"phase 3 (serving, dense): {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    paged_launches = phase_paged(torch, dev, ctx)
    log(f"phase 3b (serving, paged): {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    phase_graph_vs_eager(torch, dev, ctx)
    log(f"phase 3c (graph vs eager): {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    phase_paths(torch, dev)
    log(f"phase 4 (kernel vs plain path): {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    train_launches = phase_training(torch, dev)
    log(f"phase 5 (training): {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    sampled_launches = phase_sampled(torch, dev, ctx)
    log(f"phase 6 (sampled serving, HTTP): {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    phase7_launches = phase_baselines(torch, dev, ctx)
    log(f"phase 7 (the six decoders): {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    phase8_launches = phase_tuning_and_benches(torch, dev, ctx)
    log(f"phase 8 (tuning and benches): {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    arch_launches = phase_architectures(torch, dev, smi)
    log(f"phase 9 (other architectures): {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    extras_launches = phase_extras(torch, dev, smi)
    log(f"phase 10 (request extras, long window): "
        f"{time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    phase_parallel(torch, dev, smi)
    log(f"phase 11 (parallel decode, roofline, examples): "
        f"{time.perf_counter() - t:.1f} s")
    log(f"total: {time.perf_counter() - t_all:.1f} s")

    # launches: summed over the main-path runs (phase 3, both runs of phase
    # 3b, phase 5, phase 6's, phase 7a's and phase 8b's), each counted
    # from 0
    sources = {"decode_attention": (DECODE_SRC, DECODE_TPU),
               "fused_select": (SELECT_SRC, SELECT_TPU),
               "paged_decode_attention": (DECODE_SRC, PAGED_TPU),
               "block_attention": (BLOCK_SRC, BLOCK_TPU),
               "xent_forward": (XENT_SRC, XENT_TPU),
               "xent_backward": (XENT_SRC, XENT_BWD_TPU),
               **{name: (ELEMENTWISE_SRC, ELEMENTWISE_TPU)
                  for name in ELEMENTWISE_KERNELS}}
    xent = main_recs["xent"]
    main_recs["xent_forward"] = dict(xent["forward"],
                                     max_abs_err=xent["max_abs_err"])
    main_recs["xent_backward"] = dict(
        xent["backward"], max_abs_err=max(xent["dh_max_abs_err"],
                                          xent["dw_max_abs_err"]))
    summary = []
    for name in KERNELS:
        rec = main_recs[name]
        launches = (ctx["launches"][name] + paged_launches[name]
                    + train_launches[name] + sampled_launches[name]
                    + phase7_launches[name] + phase8_launches[name])
        if launches == 0:
            raise AssertionError(f"{name}: never launched on the main path")
        src, tpu = sources[name]
        summary.append({
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "launches": launches, "max_abs_err": rec["max_abs_err"],
            "ms": rec["kernel_ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"]})
    # sdar-30b-a3b's kernels: times and errors from phase 2, launches from
    # its phase 9 runs (two of its 48 layers, served through the engine)
    for name, src, tpu in (("grouped_moe", MOE_SRC, MOE_TPU),
                           ("qkv_rope_qk_norm", ELEMENTWISE_SRC,
                            ELEMENTWISE_TPU)):
        rec = main_recs[name]
        summary.append({
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "launches": arch_launches.pop(name),
            "max_abs_err": rec["max_abs_err"],
            "ms": rec["kernel_ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": None})
    # the attention and select kernels at each of phase 9's configs: times
    # and errors from phase 2's bf16 cases at the config's shapes, launches
    # from its phase 9 runs
    for key, launches in arch_launches.items():
        rec = main_recs[key]
        name = key.split()[0]
        if (key.split()[1] in SHAPE_KEYED
                and len(rec.get("cases", [key])) != 1):
            raise AssertionError(f"{key}: records of {rec['cases']}")
        src, tpu = sources[name]
        summary.append({
            "name": key, "route": "cuda", "source": src, "replaces": tpu,
            "launches": launches, "max_abs_err": rec["max_abs_err"],
            "ms": rec["kernel_ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"]})
    # the kernels at phase 10's configs and shapes: times and errors from
    # phase 2's bf16 cases (check_extras_kernels), launches from phase 10
    for key, name in EXTRAS_KEYS.items():
        rec = main_recs[key]
        src, tpu = sources[name]
        summary.append({
            "name": key, "route": "cuda", "source": src, "replaces": tpu,
            "launches": extras_launches[key],
            "max_abs_err": rec["max_abs_err"], "ms": rec["kernel_ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]})
    log(json.dumps({"kernels": summary}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
