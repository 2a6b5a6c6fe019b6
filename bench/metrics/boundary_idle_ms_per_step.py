"""Scheduler: the device's idle ms inside ``engine.step`` and outside its
block loop (scheduling, the admission, the commit pass, the step's end)
per step in the traced span, from the program's own ranges
(``harness/phases.py``)."""
from harness import phases as PH


def read(ctx):
    split = PH.split(ctx.trace)
    if split is None:
        return None
    return 1e-6 * split["boundary"] / split["steps"]
