"""Execution-mode policy: the paper's PE types mapped to the port's modes.

| QAPPA PE   | mode      | serve                               | train (QAT)             |
|------------|-----------|-------------------------------------|-------------------------|
| FP32       | fp32      | float32                             | float32                 |
| INT16      | bf16      | bf16                                | bf16                    |
| LightPE-2  | w8a8      | int8 x int8 CUDA kernel             | int8 fake-quant (STE)   |
| LightPE-1  | w4a8_pow2 | int8 x packed pow2-int4 CUDA kernel | pow2 fake-quant (STE)   |
"""

from __future__ import annotations

import dataclasses
import enum

import torch

from repro_torch.core.pe import PEType


class ExecMode(str, enum.Enum):
    FP32 = "fp32"
    BF16 = "bf16"
    W8A8 = "w8a8"               # LightPE-2 analogue
    W4A8_POW2 = "w4a8_pow2"     # LightPE-1 analogue


PE_TO_MODE = {
    PEType.FP32: ExecMode.FP32,
    PEType.INT16: ExecMode.BF16,
    PEType.LIGHTPE2: ExecMode.W8A8,
    PEType.LIGHTPE1: ExecMode.W4A8_POW2,
}

MODE_TO_PE = {v: k for k, v in PE_TO_MODE.items()}


def mode_for_pe(pe_type) -> ExecMode:
    """The execution mode for a QAPPA PE type; ``ValueError`` when the
    type has no mapping."""
    try:
        return PE_TO_MODE[PEType(pe_type)]
    except (KeyError, ValueError):
        raise ValueError(
            f"PE type {pe_type!r} has no execution-mode mapping; add it to "
            f"repro_torch.quant.policy.PE_TO_MODE (known: "
            f"{sorted(t.value for t in PE_TO_MODE)})") from None


def pe_for_mode(mode) -> PEType:
    """Inverse of :func:`mode_for_pe`, with the same failure contract."""
    try:
        return MODE_TO_PE[ExecMode(mode)]
    except (KeyError, ValueError):
        raise ValueError(
            f"execution mode {mode!r} has no PE-type mapping; add it to "
            f"repro_torch.quant.policy.PE_TO_MODE (known: "
            f"{sorted(m.value for m in MODE_TO_PE)})") from None


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """Resolved numerics policy for a model instance.  QAT fake-quantizes
    weights per output channel and, with ``qat_acts`` (the reference's
    field; False only in the dry run's weight-only QAT cells), activations
    per tensor (``qlinear.weight_quant_spec`` / ``act_quant_spec``)."""

    mode: ExecMode = ExecMode.BF16
    qat_acts: bool = True

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.float32 if self.mode == ExecMode.FP32 \
            else torch.bfloat16

    @property
    def quantized(self) -> bool:
        return self.mode in (ExecMode.W8A8, ExecMode.W4A8_POW2)

    @property
    def weight_bits(self) -> int:
        return {ExecMode.FP32: 32, ExecMode.BF16: 16,
                ExecMode.W8A8: 8, ExecMode.W4A8_POW2: 4}[self.mode]

    @property
    def act_bits(self) -> int:
        return {ExecMode.FP32: 32, ExecMode.BF16: 16,
                ExecMode.W8A8: 8, ExecMode.W4A8_POW2: 8}[self.mode]

    @property
    def pe_type(self) -> PEType:
        return pe_for_mode(self.mode)


def policy_for(mode: ExecMode | str | None) -> QuantPolicy:
    if mode is None:
        return QuantPolicy()
    return QuantPolicy(mode=ExecMode(mode))
