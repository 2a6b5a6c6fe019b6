"""Device, the whole step of a MoE decoder: the model operations the
window's engine steps needed (``counts/moe_step``: the projections, the
router and every routed pair, attention and the select, over only the
lanes that ran, the prompts admitted, each lane's real cache length) over
the summed wall of those ``step()`` calls times the card's bf16 peak, %.
The profiled steps are left out: the profiler slows the host."""


def read(ctx):
    count = ctx.count("moe_step")
    flops = wall = 0.0
    for st in ctx.win.steps:
        if st.traced or not st.events:
            continue
        flops += count.step_flops(
            ctx.model, block=ctx.block, prompt_len=ctx.prompt_len,
            cache_lens=ctx.cache_lens(st), admitted=ctx.admitted(st),
            iters=ctx.iters(st), fused_select=ctx.fused_select)
        wall += st.t1 - st.t0
    if ctx.trace is None or wall <= 0:
        return None
    return 100.0 * flops / (wall * ctx.peaks["bf16_flops"])
