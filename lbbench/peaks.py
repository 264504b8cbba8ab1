"""The table of peaks: one NVIDIA H100 SXM (H100 80GB HBM3), NVIDIA's
data sheet, dense rates at the 700 W power limit. A roofline share is
stated against these, with the card's power limit beside it."""

FP32_FLOPS = 67e12      # float32 outside the tensor cores, FLOP/s
HBM_BYTES = 3.35e12     # HBM3 bandwidth, B/s


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time ``flops`` operations and ``nbytes`` bytes of traffic
    to the card's memory take: the larger of the two bounds."""
    return max(flops / FP32_FLOPS, nbytes / HBM_BYTES)
