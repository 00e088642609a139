"""QAPPA core on torch: accelerator template, PE models, synthesis
oracle, batched row-stationary sweep and the exploration entry point."""

from repro_torch.core.dse import DSEResult, ExploreSpec, pareto_front, run  # noqa
