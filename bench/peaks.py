"""Published peaks of one NVIDIA H100 SXM (dense, no sparsity, at its 700 W
limit): what every roofline and MFU share in the benchmark is taken of."""
F32_FLOPS = 67e12          # float32 outside the tensor cores, FLOP/s
HBM_BYTES_PER_S = 3.35e12  # HBM3, bytes/s
BF16_FLOPS = 989e12        # bfloat16 on the tensor cores, FLOP/s
