"""Model forward: device ms of the kernels in no other group (PyTorch's
elementwise kernels: norms, RoPE, SwiGLU, casts, gathers, the threshold
rule) per refinement iteration of the traced span."""


def read(ctx):
    iters = sum(ctx.iters(st) for st in ctx.traced_steps)
    if ctx.trace is None or not iters:
        return None
    return 1e3 * ctx.group_s.get("other", 0.0) / iters
