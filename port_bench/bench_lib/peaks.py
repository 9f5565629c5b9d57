"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at the 700 W
limit): the yardstick of every roofline share and of the MFU."""

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12  # tensor cores
FP32_FLOPS = 67e12  # outside the tensor cores


def bound_s(nbytes: float, flops: float, flops_peak: float = BF16_FLOPS) -> float:
    """Least time a call can take: the larger of its bytes over the HBM rate
    and its operations over ``flops_peak``."""
    return max(nbytes / HBM_BYTES_PER_S, flops / flops_peak)
