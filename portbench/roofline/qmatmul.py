"""One quantized projection ``(m, k) x (k, n)``: int8 activations, the
weights at ``weight_bytes`` a value (1 for int8, 0.5 for 4-bit codes),
one float32 scale a column and one for the activations, float32 out.
Each input read once, each output written once."""

from __future__ import annotations

from portbench.roofline import peaks


def ops(m: int, k: int, n: int) -> float:
    return 2.0 * m * k * n


def nbytes(m: int, k: int, n: int, weight_bytes: float) -> float:
    return m * k + k * n * weight_bytes + 4.0 * n + 4.0 + 4.0 * m * n


def least_s(m: int, k: int, n: int, weight_bytes: float) -> float:
    """The least time the card could take: operations at the int8 peak
    or bytes at HBM's, whichever is longer."""
    return max(ops(m, k, n) / peaks.INT8_OPS,
               nbytes(m, k, n, weight_bytes) / peaks.HBM_BYTES)
