"""The fused unembed + select (``kernels/select``): operations and bytes
of one call over the rows of the lanes that ran.

2 d V operations a row (the logits' product; the softmax's and argmax's
work is of lower order). Bytes: the (V, d) unembedding once a call, each
row's hidden state and mask flag read once, its candidate (int32) and
confidence (fp32) written once."""


def call(model: dict, rows: int, dtype_bytes: int = 2):
    d, V = model["d_model"], model["vocab_size"]
    flops = 2 * rows * d * V
    nbytes = dtype_bytes * (V * d + rows * d) + rows * (1 + 4 + 4)
    return flops, nbytes
