"""Decode attention (``kernels/decode_attn``, dense and paged): operations
and bytes of one layer's call over the lanes that ran.

A lane whose cache holds ``S`` rows runs its block of ``B`` queries
against the ``S`` cached keys and the block's own ``B``: 4 B (S + B) hd
operations a head. Bytes: the cached K and V rows (Kv heads) once, the
block's own k and v, q read and o written once, in the served dtype. The
lanes that did not run, and rows past a lane's cache, do not count."""


def call(model: dict, block: int, cache_lens, dtype_bytes: int = 2):
    hd = model["head_dim"]
    hq, kv = model["n_heads"], model["n_kv_heads"]
    flops = nbytes = 0
    for S in cache_lens:
        flops += 4 * block * (S + block) * hq * hd
        nbytes += dtype_bytes * hd * (2 * S * kv + 2 * block * kv
                                      + 2 * block * hq)
    return flops, nbytes
