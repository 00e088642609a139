"""PyTorch + CUDA port of the QAPPA reproduction.

A second package beside :mod:`repro` (the JAX reference, which it never
imports).  This slice carries the design-space sweep: enumerate configs,
synthesize them on the host, map and cost them on the card through a
hand-written CUDA kernel, and stream a running Pareto front —
``repro_torch.core.dse.run(ExploreSpec.single(...))``.
"""
