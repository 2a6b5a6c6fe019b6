"""Scheduler: the median time a request waited in the queue before its
admission, ms: ``GenerationOutput.queue_s`` of the requests the window
finished."""
import statistics


def read(ctx):
    waits = [out.queue_s for out in ctx.win.outputs.values()]
    return 1e3 * statistics.median(waits) if waits else None
