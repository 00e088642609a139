"""Optimizers of the port: AdamW (:mod:`repro_torch.optim.adamw`)."""
