"""W4A8-pow2 projection on ``w4a8_tc_kernel``: codes at half a byte."""

from portbench.roofline import qmatmul

KERNEL = "w4a8_tc_kernel"
MODE = "w4a8_pow2"
WEIGHT_BYTES = 0.5


def least_s(m: int, k: int, n: int) -> float:
    return qmatmul.least_s(m, k, n, WEIGHT_BYTES)
