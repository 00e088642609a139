"""Preemption-safe exploration runtime (port of :mod:`repro.runtime`)."""
