"""The card's peaks, from NVIDIA's H100 SXM data sheet (dense rates, at
the full 700 W power limit): HBM3 bandwidth and float32 outside the tensor
cores. A roofline share is stated against them with the card's power
limit beside it."""

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def roofline_share(seconds: float, n_bytes: float, flops: float) -> tuple[float, str]:
    """The share [%] of the least time the card could take for a call of
    ``n_bytes`` moved and ``flops`` float32 operations in ``seconds``, and
    which of the two bounds it."""
    t_bytes, t_flops = n_bytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    bound = "bytes" if t_bytes >= t_flops else "flops"
    return 100.0 * max(t_bytes, t_flops) / seconds, bound
