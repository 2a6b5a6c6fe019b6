"""Scheduler: the mean number of lanes decoding per block decode inside
the window, from the engine's ``concurrency_stats()`` and its ``commit``
call count at the window's open and close."""


def read(ctx):
    (n0, a0), (n1, a1) = ctx.win.lanes0, ctx.win.lanes1
    return (a1 * n1 - a0 * n0) / (n1 - n0) if n1 > n0 else None
