"""Kernels: block attention's share of its roofline, %: the least time the
card could take for the admitted prompts' prefill attention
(``counts/block_attn``, each layer's call bounded by the larger of its
operations and its bytes), over the device time of ``block_attn*`` in the
traced span."""


def read(ctx):
    dev = ctx.group_s.get("block_attention", 0.0)
    if ctx.trace is None or dev <= 0:
        return None
    count = ctx.count("block_attn")
    bound = 0.0
    for st in ctx.traced_steps:
        n = ctx.admitted(st)
        if n:
            bound += ctx.model["n_layers"] * ctx.bound_s(
                *count.call(ctx.model, ctx.prompt_len, n))
    return 100.0 * bound / dev if bound else None
