"""The least time a card could take for one kernel's work: the roofline
bound every kernel row of ``chip_smoke.py`` and
``benchmarks/bench_kernels_torch.py`` stands beside."""
from __future__ import annotations

from repro_torch.configs.base import H100, H100_FP32_FLOPS


def bound_ms(n_bytes: float, n_ops: float, dtype: str):
    """(ms, "bytes" or "operations") on the H100: the larger of ``n_bytes``
    over its HBM bytes/s and ``n_ops`` over its peak for ``dtype``
    ("bfloat16": the dense tensor-core rate; "float32": the rate outside
    the tensor cores, which the fp32 kernels use)."""
    peak = {"bfloat16": H100.peak_flops, "float32": H100_FP32_FLOPS}[dtype]
    t_bytes, t_ops = n_bytes / H100.hbm_bw, n_ops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")
