"""The table of peaks: NVIDIA's data sheet for one H100 SXM5 at its 700 W
power limit, dense rates without sparsity. A card set below 700 W runs
slower under load; every run prints its power limit beside its shares."""

H100 = {"bf16_flops": 989e12,          # tensor cores, bf16 and fp16
        "fp32_flops": 67e12,           # outside the tensor cores
        "hbm_bytes_per_s": 3.35e12,
        "hbm_bytes": 80e9}


def bound_s(flops: float, nbytes: float, peaks: dict = H100) -> float:
    """The least time the card could take for ``flops`` bf16 operations
    and ``nbytes`` bytes of HBM traffic: the larger of the two terms."""
    return max(flops / peaks["bf16_flops"], nbytes / peaks["hbm_bytes_per_s"])
