"""Model forward: the projections' share of their roofline, %: the least
time the card could take for every matrix product of the traced span's
forwards (``counts/matmul``: the admitted prompts' prefill, each
iteration's and the commit pass's cached forward over the lanes that
ran, and the dense-logits head where the cell does not fuse the select),
each product bounded by the larger of its operations and its bytes, over
the device time of the cuBLAS kernels."""


def read(ctx):
    dev = ctx.group_s.get("matmul", 0.0)
    if ctx.trace is None or dev <= 0:
        return None
    count = ctx.count("matmul")

    def bound(rows, head_rows=0):
        return sum(ctx.bound_s(fl, nb)
                   for fl, nb in count.gemms(ctx.model, rows, head_rows))

    total = 0.0
    for st in ctx.traced_steps:
        rows = ctx.block * len(st.events)
        head = 0 if ctx.fused_select else rows
        if rows:
            total += ctx.iters(st) * bound(rows, head) + bound(rows)
        n = ctx.admitted(st)
        if n:
            total += bound(ctx.prompt_len * n)
    return 100.0 * total / dev if total else None
