from typing import Callable, NamedTuple

from repro_torch.kernels.elementwise.ops import (  # noqa: F401
    add_rmsnorm,
    gated_act,
    qkv_rope,
)
from repro_torch.kernels.moe import grouped_experts


class ElementwiseFns(NamedTuple):
    """The fused passes a forward takes between its matmuls
    (``models/transformer.py::forward``'s ``elementwise_fns``), each where
    it covers the input, and ``moe``, the dropless grouped expert product
    of a ``moe_dispatch`` "grouped" config; the defaults are the CUDA
    kernels' wrappers."""
    add_norm: Callable = add_rmsnorm
    qkv_rope: Callable = qkv_rope
    gated_act: Callable = gated_act
    moe: Callable = grouped_experts
