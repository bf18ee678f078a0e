"""Published peaks of one NVIDIA H100 SXM 80 GB (NVIDIA's data sheet,
dense rates, at the 700 W power limit)."""

#: float32 operations a second outside the tensor cores
FP32_FLOPS = 67e12
#: HBM3 bytes a second
HBM_BYTES = 3.35e12


def least_seconds(ops: float, nbytes: float) -> float:
    """The least time a kernel can take: the larger of its operations at
    the fp32 peak and its bytes at the HBM peak."""
    return max(ops / FP32_FLOPS, nbytes / HBM_BYTES)
