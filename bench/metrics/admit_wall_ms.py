"""Admission prefill: ms from the start of an admission (``engine.admit``)
to the end of the host's first read of ``active`` after it
(``engine.sync``), the mean over the traced span's admissions; None
where it holds none. The step before ended in a read of the canvases, so
the device's queue is about empty when the admission starts, and that
first read is where the host first waits for the prefill."""
from harness import phases as PH


def read(ctx):
    walls = PH.admit_walls(ctx.trace)
    return 1e-6 * sum(walls) / len(walls) if walls else None
