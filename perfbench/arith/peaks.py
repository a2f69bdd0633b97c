"""Published peaks of one NVIDIA H100 SXM5 80 GB (NVIDIA H100 Tensor Core
GPU data sheet, dense rates without sparsity, at the 700 W power limit).
A card set below 700 W (``power.limit``) runs slower under load: every
result prints the limit beside the shares computed against these."""

HBM_BYTES_PER_S = 3.35e12    # HBM3 bandwidth
F32_FLOPS = 67e12            # float32 outside the tensor cores
BF16_FLOPS = 989e12          # bf16 / fp16 tensor cores, dense
