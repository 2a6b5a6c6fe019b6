"""Sharding rules and sequence-parallel decode on ``torch.distributed``,
the counterpart of the JAX package's ``parallel/``."""
from repro_torch.parallel.seq_decode import make_sharded_decode_attention  # noqa: F401,E501
from repro_torch.parallel.sharding import (  # noqa: F401
    batch_axes,
    cache_spec,
    cache_specs,
    param_placements,
    param_specs,
    spec_for_leaf,
)
