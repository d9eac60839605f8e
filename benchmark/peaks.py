"""Published dense peaks of one NVIDIA H100 SXM 80 GB (NVIDIA's data
sheet, without sparsity, at the 700 W power limit). A share of a peak is
stated against these, with the card's power limit beside it."""

BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
HBM_BYTES_PER_S = 3.35e12
