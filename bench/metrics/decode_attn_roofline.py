"""Kernels: decode attention's share of its roofline, %: the least time
the card could take for the cached forwards' attention (each iteration's
and the commit pass's, over the lanes that ran at their cache lengths,
``counts/decode_attn``), over the device time of ``decode_attn*`` and
``decode_merge*`` in the traced span."""


def read(ctx):
    dev = ctx.group_s.get("decode_attention", 0.0)
    if ctx.trace is None or dev <= 0:
        return None
    count = ctx.count("decode_attn")
    bound = 0.0
    for st in ctx.traced_steps:
        lens = ctx.cache_lens(st)
        if lens:
            calls = (ctx.iters(st) + 1) * ctx.model["n_layers"]
            bound += calls * ctx.bound_s(*count.call(ctx.model, ctx.block,
                                                     lens))
    return 100.0 * bound / dev if bound else None
