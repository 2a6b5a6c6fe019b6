"""Kernels: the grouped MoE's share of its roofline, %: the least time the
card could take for every MoE layer of the traced span's forwards
(``counts/moe``: the admitted prompts' prefill, each iteration's and the
commit pass's cached forward over the lanes that ran), each layer's call
bounded by the larger of its operations and its bytes, over the device
time of the ``moe_*`` kernels (alignment, gather, the two grouped
products, combine)."""


def moe_seconds(trace) -> float:
    return sum(b - a for name, a, b in trace.device()
               if name.startswith("moe_")) * 1e-9


def read(ctx):
    if ctx.trace is None:
        return None
    dev = moe_seconds(ctx.trace)
    if dev <= 0:
        return None
    count = ctx.count("moe")
    n = ctx.model["n_layers"]

    def bound(tokens):
        return n * ctx.bound_s(*count.call(ctx.model, tokens))

    total = 0.0
    for st in ctx.traced_steps:
        rows = ctx.block * len(st.events)
        if rows:
            total += (ctx.iters(st) + 1) * bound(rows)
        if ctx.admitted(st):
            total += bound(ctx.prompt_len * ctx.admitted(st))
    return 100.0 * total / dev if total else None
