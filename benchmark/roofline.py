"""The card's published peaks and the bound they set on a piece of work.

NVIDIA H100 SXM data sheet: 3.35 TB/s of HBM3 bandwidth and 67 TFLOP/s of fp32
outside the tensor cores, at the card's full 700 W. A share of a bound is stated
with the card's power limit beside it.
"""

PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12


def bound_ms(bytes_moved: float, flops: float) -> tuple[float, str]:
    """The least time the card could take, and what bounds it ("bytes" or "operations")."""
    byte_ms = bytes_moved / PEAK_BYTES_PER_S * 1e3
    flop_ms = flops / PEAK_FP32_FLOP_PER_S * 1e3
    return (byte_ms, "bytes") if byte_ms >= flop_ms else (flop_ms, "operations")
