"""Kernels: the fused select's share of its roofline, %: the least time
the card could take for each iteration's unembedding and selection over
the rows of the lanes that ran (``counts/select``), over the device time
of ``select_*`` in the traced span."""


def read(ctx):
    dev = ctx.group_s.get("select", 0.0)
    if ctx.trace is None or dev <= 0:
        return None
    count = ctx.count("select")
    bound = 0.0
    for st in ctx.traced_steps:
        rows = ctx.block * len(st.events)
        if rows:
            bound += ctx.iters(st) * ctx.bound_s(*count.call(ctx.model, rows))
    return 100.0 * bound / dev if bound else None
