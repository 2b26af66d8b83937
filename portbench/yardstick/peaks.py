"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit)."""

BF16_FLOP_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12
