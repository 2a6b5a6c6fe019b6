"""Device: the share of the traced span, %, in which no kernel or copy
ran (1 - the union of their intervals over the span's wall)."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s() <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s())
