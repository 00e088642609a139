"""The quantizer pairs of each PE type, from :mod:`repro.quant.calibrate`.

Only :data:`PE_QUANT_SPECS` is here: the tier-0 accuracy proxy
(:mod:`repro_torch.explore.objectives`) measures its noise table with
these pairs.  The tier-1 calibration on model tensors is not ported yet.
"""

from __future__ import annotations

from repro_torch.core.pe import PEType
from repro_torch.quant.quantizers import FakeQuantSpec

# mode -> (weight spec, activation spec); None = native precision
PE_QUANT_SPECS: dict[PEType, tuple[FakeQuantSpec | None,
                                   FakeQuantSpec | None]] = {
    PEType.FP32: (None, None),
    PEType.INT16: (FakeQuantSpec("int", 16), FakeQuantSpec("int", 16)),
    PEType.LIGHTPE1: (FakeQuantSpec("pow2"), FakeQuantSpec("int", 8)),
    PEType.LIGHTPE2: (FakeQuantSpec("pow2_2term"), FakeQuantSpec("int", 8)),
}
