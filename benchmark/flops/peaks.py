"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit): HBM bytes/s and bf16
tensor-core FLOP/s. A share of a roofline or of a peak is stated against
these, with the card's power limit beside it."""

HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
