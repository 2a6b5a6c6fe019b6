"""The model operations one engine step needs: every forward of the step
over the rows that count (``decode_attn``, ``block_attn``, ``select`` and
``matmul``'s counts together).

A step of ``iters`` refinement iterations over lanes at cache lengths
``cache_lens`` with ``admitted`` prompts of ``prompt_len``: the admission
prefill (projections and block attention of the admitted prompts), each
iteration's cached forward of the running lanes' blocks with its
selection (the fused select's product, or the dense head's) and the
commit pass's cached forward."""
from pathlib import Path

from harness import spec as SP

_MM, _DEC, _BLK, _SEL = (SP.load_module(Path(__file__).resolve().parents[2],
                                        "counts", n)
                         for n in ("matmul", "decode_attn", "block_attn",
                                   "select"))


def step_flops(model: dict, *, block: int, prompt_len: int, cache_lens,
               admitted: int, iters: int, fused_select: bool) -> int:
    n = model["n_layers"]
    rows = block * len(cache_lens)
    attn = n * _DEC.call(model, block, cache_lens)[0]
    fwd = _MM.forward_flops(model, rows)
    head = (_SEL.call(model, rows)[0] if fused_select
            else _MM.forward_flops(model, 0, head_rows=rows))
    total = iters * (fwd + attn + head) + fwd + attn
    if admitted:
        total += _MM.forward_flops(model, prompt_len * admitted)
        total += n * _BLK.call(model, prompt_len, admitted)[0]
    return total
