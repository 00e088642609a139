"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit)."""

#: int8 tensor-core operations a second
INT8_OPS = 1979e12
#: bf16 tensor-core FLOPs a second
BF16_FLOPS = 989e12
#: HBM3 bytes a second
HBM_BYTES = 3.35e12
