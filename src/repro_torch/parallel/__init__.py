"""Gradient compression of the port (:mod:`repro_torch.parallel.compression`,
port of :mod:`repro.parallel`)."""
