"""Peak rates of one NVIDIA H100 SXM (NVIDIA's data sheet: dense rates,
no sparsity, at the full 700 W power limit). A card set below that limit
runs slower under load, so every share is printed beside the card's
power limit (``device.power_limit``)."""

PEAK_BF16_FLOPS = 989e12    # bf16 / fp16 on the tensor cores
PEAK_F32_FLOPS = 67e12      # float32 off the tensor cores
PEAK_BYTES = 3.35e12        # HBM3


def least_seconds(moved_bytes: float, flops: float,
                  peak_flops: float = PEAK_BF16_FLOPS) -> float:
    """The least time the card could take: bytes over the memory rate or
    operations over the peak, whichever is longer."""
    return max(moved_bytes / PEAK_BYTES, flops / peak_flops)
