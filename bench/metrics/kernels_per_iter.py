"""Graph runner: device kernels in the traced span per refinement
iteration in it (the admission's and the commit's kernels included; the
runtime's copies are not kernels)."""


def read(ctx):
    iters = sum(ctx.iters(st) for st in ctx.traced_steps)
    if ctx.trace is None or not iters:
        return None
    return ctx.trace.n_kernels() / iters
