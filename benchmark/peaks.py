"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the 700 W limit), as the port's chip_smoke.py states them."""

BYTES_PER_S = 3.35e12  # HBM3
FP32_FLOPS = 67e12  # outside the tensor cores
TF32_FLOPS = 495e12
BF16_FLOPS = 989.4e12
