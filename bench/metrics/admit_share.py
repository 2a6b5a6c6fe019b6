"""Admission prefill: admissions per block decode inside the window
(``call_counts()`` ``admit`` / ``commit``). Every admission prefills every
lane and holds up every lane in flight."""


def read(ctx):
    commits = ctx.delta("commit")
    return ctx.delta("admit") / commits if commits else None
