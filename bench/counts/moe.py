"""The dropless grouped expert product (``kernels/moe``): operations and
bytes of one MoE layer's call over ``tokens`` tokens.

Each token's top k choices are computed: ``P = tokens k`` pairs, each
``silu(x W_gate) (x W_up)`` then ``W_down``, 2 P d f operations a product,
three products. Bytes: each expert the call routes to read once (gate, up
and down, d f values each), for the expected number of distinct experts
that P uniform picks hit, ``E (1 - (1 - 1/E)^P)`` (all E at a decode
batch's thousands of pairs); the tokens' rows read once and the layer's
output rows written once, in the served dtype. The router's product, its
softmax and top k are PyTorch's and not counted here; the pairs' own rows
(their gathered inputs and their outputs before the combine) are a layout
the kernels choose, not work the inputs need, and are not counted."""


def experts_hit(n_experts: int, pairs: int) -> float:
    return n_experts * (1.0 - (1.0 - 1.0 / n_experts) ** pairs)


def call(model: dict, tokens: int, dtype_bytes: int = 2):
    d, f = model["d_model"], model["moe_d_ff"]
    E, k = model["n_experts"], model["experts_per_token"]
    pairs = tokens * k
    flops = 2 * 3 * pairs * d * f
    nbytes = dtype_bytes * (3 * experts_hit(E, pairs) * d * f + 2 * tokens * d)
    return flops, nbytes
