"""W8A8 projection on ``w8a8_tc_kernel``: int8 weights."""

from portbench.roofline import qmatmul

KERNEL = "w8a8_tc_kernel"
MODE = "w8a8"
WEIGHT_BYTES = 1.0


def least_s(m: int, k: int, n: int) -> float:
    return qmatmul.least_s(m, k, n, WEIGHT_BYTES)
