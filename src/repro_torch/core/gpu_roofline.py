"""Three-term Hopper roofline of one step, from the op counter's totals.

The port's counterpart of ``repro.core.tpu_roofline``, re-targeted from a
TPU v5e to one NVIDIA H100: a step's counted work (``core.op_analysis``)
against the card's data-sheet peaks,

    compute term    = sum over classes of FLOPs_c / peak_c
    memory term     = bytes accessed / HBM bandwidth
    collective term = collective bytes / (NVLink links * link bandwidth)

The compute term has four classes, since the card's rate depends on the
operands' type: ``int8`` (int8 tensor-core products, the W8A8 / W4A8
kernels and the int8 decode attention), ``bf16`` (bf16 / fp16 tensor-core
products), ``fp32_dot`` (float32 products, at a third of the TF32 rate:
the 3xTF32 route by which the port's float32 flash kernel,
``kernels/csrc/flash_attention.cu``, reaches float32 accuracy on the
tensor cores) and ``fp32`` (everything else: elementwise work and
reductions on the CUDA cores).

Hardware constants: H100 SXM (NVIDIA data sheet, dense rates), the peaks
``chip_smoke.py`` and ``PERF.md`` use for the kernels' bounds.
"""

from __future__ import annotations

import dataclasses

#: the compute classes of the roofline, each at its own peak
FLOP_CLASSES = ("int8", "bf16", "fp32_dot", "fp32")


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str = "h100-sxm"
    peak_int8_ops: float = 1979e12       # int8 tensor cores, per card
    peak_bf16_flops: float = 989e12      # bf16 tensor cores
    peak_tf32_flops: float = 494.7e12    # TF32 tensor cores
    peak_fp32_flops: float = 67e12       # float32 on the CUDA cores
    hbm_bw: float = 3.35e12              # bytes/s, HBM3
    nvlink_links: int = 18
    nvlink_link_bw: float = 25e9         # bytes/s per link and direction
    hbm_gb: float = 80.0
    smem_bytes_per_sm: int = 228 * 1024
    sms: int = 132

    def peak(self, cls: str) -> float:
        """The rate of one compute class (see the module docstring)."""
        return {"int8": self.peak_int8_ops, "bf16": self.peak_bf16_flops,
                "fp32_dot": self.peak_tf32_flops / 3,
                "fp32": self.peak_fp32_flops}[cls]


H100 = ChipSpec(name="h100-sxm")


@dataclasses.dataclass
class Roofline:
    """Per (arch x shape x mesh) roofline report.  The ``hlo_*`` names
    are the reference's; here they hold the op counter's totals."""

    arch: str
    shape: str
    mesh: str
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float          # 6*N*D (train) / 2*N_active*D (serve)
    hlo_flops_per_device: float
    hlo_bytes_per_device: float
    collective_bytes_per_device: float
    chip: ChipSpec = H100
    flops_by_class: dict = dataclasses.field(default_factory=dict)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """No-overlap upper bound: max of the three terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs: how much counted compute is
        useful (< 1: attention, optimizer and elementwise work)."""
        total = self.hlo_flops_per_device * self.chips
        if total <= 0:
            return 0.0
        return self.model_flops / total

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute fraction of the bf16 peak at the bound step time
        (MFU-like), of this roofline's own chip (the reference divides by
        its v5e's peak whatever chip built it, ROADMAP C.15 a)."""
        if self.step_time_s <= 0:
            return 0.0
        achieved = self.model_flops / self.step_time_s
        return achieved / (self.chips * self.chip.peak_bf16_flops)

    def as_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "hlo_flops_per_device": self.hlo_flops_per_device,
            "hlo_bytes_per_device": self.hlo_bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "step_time_s": self.step_time_s,
            "chip": self.chip.name,
            "flops_by_class": dict(self.flops_by_class),
        }


def roofline_from_stats(stats, *, arch: str, shape: str, mesh: str,
                        chips: int, model_flops: float,
                        chip: ChipSpec = H100) -> Roofline:
    """``stats``: a :class:`~repro_torch.core.op_analysis.StepStats`."""
    by_class = {c: float(stats.flops_by_class.get(c, 0.0))
                for c in FLOP_CLASSES}
    coll = stats.collectives.total_bytes
    return Roofline(
        arch=arch, shape=shape, mesh=mesh, chips=chips,
        compute_s=sum(f / chip.peak(c) for c, f in by_class.items()),
        memory_s=stats.bytes_accessed / chip.hbm_bw,
        collective_s=coll / (chip.nvlink_links * chip.nvlink_link_bw),
        model_flops=model_flops,
        hlo_flops_per_device=stats.flops,
        hlo_bytes_per_device=stats.bytes_accessed,
        collective_bytes_per_device=coll,
        chip=chip, flops_by_class=by_class)


def dense_model_flops(n_params: float, tokens: float) -> float:
    """6*N*D training FLOPs (fwd+bwd).  For inference use 2*N*D."""
    return 6.0 * n_params * tokens


def serve_model_flops(n_params_active: float, tokens: float) -> float:
    return 2.0 * n_params_active * tokens
