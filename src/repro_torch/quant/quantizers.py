"""Quantizers in PyTorch: the port of ``repro.quant.quantizers``.

* symmetric int8 (per-tensor or per-channel): the LightPE-2 / W8A8 format;
* power-of-two 4-bit codes ``[sign | exp(3)]``: the LightPE-1 / W4A8 format;
* int4 nibble packing for the W4A8 kernel;
* quantize-dequantize driven by one :class:`FakeQuantSpec` (int, pow2,
  two-term pow2), in the reference's operation order;
* fake quantization with a straight-through gradient for QAT
  (:func:`ste`, :func:`fake_quant` and the per-kind wrappers).

Every division is a tensor by tensor division on the input's device, so it
is a true IEEE division: PyTorch turns the division of a CUDA tensor by a
Python number into a multiplication by its reciprocal, which can be 1 ulp
off and flip a ``round`` at .5.
"""

from __future__ import annotations

import dataclasses

import torch

# value = sign * scale * 2**(exp - POW2_EXP_BIAS), exp in [0, 7]
POW2_EXP_BIAS = 7


def const_like(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a 0-d tensor of ``like``'s dtype and device (a tensor
    divisor keeps a division exact on CUDA)."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


def _absmax(x: torch.Tensor, axis=None) -> torch.Tensor:
    m = x.abs().amax() if axis is None else x.abs().amax(dim=axis,
                                                         keepdim=True)
    return torch.clamp_min(m, 1e-8)


def int_scale(x: torch.Tensor, bits: int, axis=None) -> torch.Tensor:
    """Symmetric scale so that absmax maps to the max quantized level."""
    qmax = 2 ** (bits - 1) - 1
    m = _absmax(x, axis)
    return m / const_like(qmax, m)


def quantize_int(x: torch.Tensor, scale: torch.Tensor,
                 bits: int) -> torch.Tensor:
    qmax = 2 ** (bits - 1) - 1
    q = torch.clamp(torch.round(x / scale), -qmax, qmax)
    return q.to(torch.int8 if bits <= 8 else torch.int32)


def dequantize_int(q: torch.Tensor, scale: torch.Tensor,
                   dtype=torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def pow2_encode(w: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """4-bit pow2 codes ``(sign << 3) | exp`` of ``w / scale`` in int8."""
    mag = w.abs() / scale
    e = torch.round(torch.log2(torch.clamp_min(mag, 2.0 ** -POW2_EXP_BIAS)))
    e = torch.clamp(e + POW2_EXP_BIAS, 0, 7).to(torch.int8)
    sign = (w < 0).to(torch.int8)
    return (sign << 3) | e


def pow2_decode(code: torch.Tensor, scale: torch.Tensor,
                dtype=torch.float32) -> torch.Tensor:
    e = (code & 7).to(torch.int32) - POW2_EXP_BIAS
    sign = 1.0 - 2.0 * ((code >> 3) & 1).to(torch.float32)
    return (sign * torch.exp2(e.to(torch.float32)) * scale).to(dtype)


def pow2_scale(w: torch.Tensor, axis=None) -> torch.Tensor:
    """Scale that puts absmax on the top pow2 level (2^0 * scale)."""
    return _absmax(w, axis)


def pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """Pack 4-bit codes pairwise along the last dim: (..., K) -> (..., K//2);
    element 2i goes to the low nibble, 2i+1 to the high nibble."""
    if codes.shape[-1] % 2:
        raise ValueError(
            f"pack_int4: the last dim must be even, got {codes.shape[-1]}")
    lo = codes[..., 0::2].to(torch.uint8) & 0xF
    hi = codes[..., 1::2].to(torch.uint8) & 0xF
    return (lo | (hi << 4)).view(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: (..., K//2) -> (..., K) codes."""
    p = packed.contiguous().view(torch.uint8)
    lo = (p & 0xF).to(torch.int8)
    hi = ((p >> 4) & 0xF).to(torch.int8)
    return torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1], -1)


def _qdq_int(x: torch.Tensor, bits: int, axis=None) -> torch.Tensor:
    scale = int_scale(x, bits, axis).to(x.dtype)
    qmax = 2 ** (bits - 1) - 1
    q = torch.clamp(torch.round(x / scale), -qmax, qmax)
    return (q * scale).to(x.dtype)


def _qdq_pow2(w: torch.Tensor, axis=None) -> torch.Tensor:
    scale = pow2_scale(w, axis)
    return pow2_decode(pow2_encode(w, scale), scale, w.dtype)


def _qdq_pow2_2term(w: torch.Tensor, axis=None) -> torch.Tensor:
    """Two-term pow2 (LightPE-2): v1 = pow2(w), v2 = pow2(w - v1); the sum
    where it reduces the error, else v1."""
    scale = pow2_scale(w, axis)
    v1 = pow2_decode(pow2_encode(w, scale), scale, w.dtype)
    r = w - v1
    v2 = pow2_decode(pow2_encode(r, scale), scale, w.dtype)
    better = (w - (v1 + v2)).abs() < (w - v1).abs()
    return torch.where(better, v1 + v2, v1)


FAKE_QUANT_KINDS = ("none", "int", "pow2", "pow2_2term")

# code width is fixed by the datapath for the shift-based kinds
_KIND_BITS = {"none": 0, "int": 8, "pow2": 4, "pow2_2term": 8}


@dataclasses.dataclass(frozen=True)
class FakeQuantSpec:
    """One fake-quant transform: ``kind`` (``"none"`` passes through),
    ``bits`` (fixed per kind except ``"int"``), and the scale's ``axis``;
    ``per_channel`` without an ``axis`` means axis 0."""

    kind: str = "int"
    bits: int | None = None
    axis: int | None = None
    per_channel: bool = False

    def __post_init__(self):
        if self.kind not in FAKE_QUANT_KINDS:
            raise ValueError(
                f"unknown fake-quant kind {self.kind!r}; "
                f"expected one of {FAKE_QUANT_KINDS}")
        if self.bits is None:
            object.__setattr__(self, "bits", _KIND_BITS[self.kind])
        elif self.kind in ("pow2", "pow2_2term", "none"):
            if self.bits != _KIND_BITS[self.kind]:
                raise ValueError(
                    f"kind {self.kind!r} has a fixed {_KIND_BITS[self.kind]}"
                    f"-bit code; got bits={self.bits}")
        elif not 2 <= self.bits <= 32:
            raise ValueError(f"int bits must be in [2, 32]; got {self.bits}")
        if self.axis is not None and not self.per_channel:
            object.__setattr__(self, "per_channel", True)

    @property
    def resolved_axis(self) -> int | None:
        """Scale axis after applying the per_channel default (axis 0)."""
        if self.axis is not None:
            return self.axis
        return 0 if self.per_channel else None


def quantize_dequantize(x: torch.Tensor, spec: FakeQuantSpec) -> torch.Tensor:
    """Quantize-dequantize ``x`` per ``spec`` (no straight-through
    gradient)."""
    if spec.kind == "none":
        return x
    axis = spec.resolved_axis
    if spec.kind == "int":
        return _qdq_int(x, spec.bits, axis)
    if spec.kind == "pow2":
        return _qdq_pow2(x, axis)
    return _qdq_pow2_2term(x, axis)


def ste(x: torch.Tensor, qdq: torch.Tensor) -> torch.Tensor:
    """Straight-through: forward ``x + (qdq - x)``, gradient the identity.
    The forward keeps the reference's arithmetic, which in float32 is not
    always ``qdq`` itself."""
    return x + (qdq - x).detach()


def fake_quant(x: torch.Tensor, spec: FakeQuantSpec) -> torch.Tensor:
    """Fake-quantize ``x`` per ``spec``: forward qdq, gradient identity."""
    if spec.kind == "none":
        return x
    return ste(x, quantize_dequantize(x.detach(), spec))


# the reference's per-kind entry points, over the spec form

def quantize_dequantize_int(x: torch.Tensor, bits: int,
                            axis=None) -> torch.Tensor:
    return quantize_dequantize(x, FakeQuantSpec("int", bits, axis))


def quantize_dequantize_pow2(w: torch.Tensor, axis=None) -> torch.Tensor:
    return quantize_dequantize(w, FakeQuantSpec("pow2", axis=axis))


def quantize_dequantize_pow2_2term(w: torch.Tensor,
                                   axis=None) -> torch.Tensor:
    return quantize_dequantize(w, FakeQuantSpec("pow2_2term", axis=axis))


def fake_quant_int(x: torch.Tensor, bits: int, axis=None) -> torch.Tensor:
    return fake_quant(x, FakeQuantSpec("int", bits, axis))


def fake_quant_pow2(x: torch.Tensor, axis=None) -> torch.Tensor:
    return fake_quant(x, FakeQuantSpec("pow2", axis=axis))


def fake_quant_pow2_2term(x: torch.Tensor, axis=None) -> torch.Tensor:
    return fake_quant(x, FakeQuantSpec("pow2_2term", axis=axis))
