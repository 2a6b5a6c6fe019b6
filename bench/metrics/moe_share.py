"""Model forward: the ``moe_*`` kernels' device time over all kernel time
of the traced span (copies and fills left out), %: how much of the
device's work the grouped MoE is."""


def read(ctx):
    if ctx.trace is None:
        return None
    moe = every = 0
    for name, a, b in ctx.trace.device():
        if name.startswith(("Memcpy", "Memset")):
            continue
        every += b - a
        if name.startswith("moe_"):
            moe += b - a
    return 100.0 * moe / every if moe else None
