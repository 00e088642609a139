"""Snapshot format of the exploration runtime (port of
:mod:`repro.checkpoint`)."""
