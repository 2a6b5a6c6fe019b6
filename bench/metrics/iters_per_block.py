"""Block loop: refinement iterations per block decode inside the window
(``call_counts()`` ``refine`` / ``commit``)."""


def read(ctx):
    commits = ctx.delta("commit")
    return ctx.delta("refine") / commits if commits else None
