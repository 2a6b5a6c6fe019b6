"""Block loop and graph runner: the device's idle ms inside the block
loop (``engine.block`` outside ``engine.commit``) per refinement iteration
(``engine.refine``) in the traced span, from the program's own ranges
(``harness/phases.py``): the gap between an iteration's read of
``active`` and the next graph's kernels."""
from harness import phases as PH


def read(ctx):
    split = PH.split(ctx.trace)
    if split is None or not split["iters"]:
        return None
    return 1e-6 * split["loop"] / split["iters"]
