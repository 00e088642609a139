"""Causal bf16 self-attention on ``flash_tc_kernel``: the live (q, k)
pairs' two products, or q, k, v and o read or written once (k and v at
their kv heads), whichever bounds it."""

from __future__ import annotations

from portbench.roofline import peaks

KERNEL = "flash_tc_kernel"


def flops(s: int, h: int, hd: int) -> float:
    """QK^T and PV over the s (s + 1) / 2 live pairs of each head."""
    return 4.0 * h * hd * s * (s + 1) / 2


def nbytes(s: int, h: int, kvh: int, hd: int) -> float:
    return 2.0 * s * hd * (2 * h + 2 * kvh)


def least_s(s: int, h: int, kvh: int, hd: int) -> float:
    return max(flops(s, h, hd) / peaks.BF16_FLOPS,
               nbytes(s, h, kvh, hd) / peaks.HBM_BYTES)
