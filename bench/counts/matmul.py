"""The projections of one forward (cuBLAS): operations and bytes of each
matrix product, over ``rows`` rows (the rows of the lanes that ran, or of
the prompts admitted), and of the dense-logits head over ``head_rows``.

A product of (rows, k) by (k, n): 2 rows k n operations; bytes: the
weight once, the input read once and the output written once, in the
served dtype. Per layer: q, k, v (with the QKV bias folded in), o, the
gate, the up and the down projections. The head's product is counted in
the served dtype too, whatever precision the program runs it in (its
logits written once in fp32): the least time the card could take."""


def gemms(model: dict, rows: int, head_rows: int = 0, dtype_bytes: int = 2):
    """[(flops, bytes)] of every product of one forward."""
    d, f, n = model["d_model"], model["d_ff"], model["n_layers"]
    hd = model["head_dim"]
    nq, nkv = model["n_heads"] * hd, model["n_kv_heads"] * hd
    shapes = [(d, nq), (d, nkv), (d, nkv), (nq, d), (d, f), (d, f), (f, d)]
    out = []
    if rows:
        for k, m in shapes:
            out += [(2 * rows * k * m,
                     dtype_bytes * (k * m + rows * k + rows * m))] * n
    if head_rows:
        V = model["vocab_size"]
        out.append((2 * head_rows * d * V,
                    dtype_bytes * (V * d + head_rows * d) + 4 * head_rows * V))
    return out


def forward_flops(model: dict, rows: int, head_rows: int = 0) -> int:
    return sum(fl for fl, _ in gemms(model, rows, head_rows))
