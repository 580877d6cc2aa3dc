"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates at the 700 W power limit)."""

BF16_FLOPS = 989e12          # dense bf16 tensor-core FLOP/s
HBM_BYTES = 3.35e12          # HBM3 bytes/s
