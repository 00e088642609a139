"""PyTorch + CUDA port of the QAPPA reproduction.

A second package beside :mod:`repro` (the JAX reference, which it never
imports).  Three paths are ported:

* the design-space sweep: enumerate configs, synthesize them on the host,
  map and cost them on the card through a hand-written CUDA kernel, and
  stream a running Pareto front —
  ``repro_torch.core.dse.run(ExploreSpec.single(...))``;
* quantized LM serving of the dense models in W8A8 and W4A8-pow2, every
  projection on a hand-written CUDA matmul kernel —
  ``repro_torch.launch.serve.serve(arch, quantize=True)``;
* continuous batching over an int8 KV cache and the full-sequence
  forward / prefill, attention on hand-written CUDA kernels (int8 decode
  attention, flash attention) —
  ``repro_torch.serving.scheduler.ContinuousBatcher``,
  ``repro_torch.models.model.Model.forward`` / ``prefill``.
"""
