"""QAPPA core on torch: accelerator template, PE models, synthesis
oracle, batched row-stationary sweep and the exploration entry point, and
the Hopper roofline of a counted step."""

from repro_torch.core.dse import DSEResult, ExploreSpec, pareto_front, run  # noqa
from repro_torch.core.gpu_roofline import Roofline, roofline_from_stats  # noqa
