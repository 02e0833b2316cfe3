"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates at the full 700 W power limit). A roofline share is stated against
these, with the card's power limit beside it."""

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12          # float32 outside the tensor cores
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
MEMORY_BYTES = 80e9
L2_BYTES = 50 * 2 ** 20
