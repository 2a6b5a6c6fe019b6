"""The model operations one engine step of a MoE decoder (every layer an
``(attn, moe)`` slot, sdar-30b-a3b) needs: every forward of the step over
the rows that count.

A forward over ``rows`` rows: per layer the q, k, v and o projections
(2 rows d n each), the router's product (2 rows d E) and the routed pairs
(``counts/moe``: every choice of every row); its attention (decode
attention over each running lane's cache for the cached forwards, block
attention over each admitted prompt for the prefill, ``counts/decode_attn``
and ``counts/block_attn``). A step of ``iters`` refinement iterations over
lanes at cache lengths ``cache_lens`` with ``admitted`` prompts of
``prompt_len``: the admitted prompts' prefill, each iteration's cached
forward of the running lanes' blocks with its selection (the fused
select's product, ``counts/select``, or the dense head's) and the commit
pass's cached forward. Only the lanes that ran and the prompts admitted
count, not every lane the program computes."""
from pathlib import Path

from harness import spec as SP

_MOE, _DEC, _BLK, _SEL = (SP.load_module(Path(__file__).resolve().parents[2],
                                         "counts", n)
                          for n in ("moe", "decode_attn", "block_attn",
                                    "select"))


def layer_flops(model: dict, rows: int) -> int:
    """One layer's projections, router and routed pairs over ``rows``."""
    d, hd, E = model["d_model"], model["head_dim"], model["n_experts"]
    nq, nkv = model["n_heads"] * hd, model["n_kv_heads"] * hd
    proj = 2 * rows * d * (2 * nq + 2 * nkv)
    return proj + 2 * rows * d * E + _MOE.call(model, rows)[0]


def step_flops(model: dict, *, block: int, prompt_len: int, cache_lens,
               admitted: int, iters: int, fused_select: bool) -> int:
    n, d, V = model["n_layers"], model["d_model"], model["vocab_size"]
    rows = block * len(cache_lens)
    fwd = n * (layer_flops(model, rows)
               + _DEC.call(model, block, cache_lens)[0])
    head = (_SEL.call(model, rows)[0] if fused_select
            else 2 * rows * d * V)
    total = iters * (fwd + head) + fwd
    if admitted:
        total += n * (layer_flops(model, prompt_len * admitted)
                      + _BLK.call(model, prompt_len, admitted)[0])
    return total
