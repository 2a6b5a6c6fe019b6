"""Block attention (``kernels/block_attn``) at the admission prefill:
operations and bytes of one layer's call over the admitted prompts.

The prompt is one block under the block-causal mask, so each of its
``P`` queries sees all ``P`` keys: 4 P^2 hd operations a head (QK^T and
PV, two per multiply-add). Bytes: q and o (Hq heads) and k and v (Kv
heads) once each, in the served dtype. Only the prompts admitted count,
not every lane the program prefills."""


def call(model: dict, prompt_len: int, n_prompts: int, dtype_bytes: int = 2):
    P, hd = prompt_len, model["head_dim"]
    hq, kv = model["n_heads"], model["n_kv_heads"]
    flops = 4 * n_prompts * P * P * hq * hd
    nbytes = dtype_bytes * n_prompts * P * hd * (2 * hq + 2 * kv)
    return flops, nbytes
