"""repro_torch.obs — unified telemetry for the exploration runtime.

Copy of :mod:`repro.obs`; spans mirror into ``torch.profiler`` ranges
instead of jax profiler annotations.

Three zero-dependency pieces:

* :mod:`repro_torch.obs.trace` — nestable span tracing (gated: off by
  default, flip with :func:`configure`), Chrome ``trace_event`` export,
  JSONL event log that survives preemption.
* :mod:`repro_torch.obs.metrics` — always-on registry of named counters /
  gauges / histograms with a flat :func:`snapshot`.
* :mod:`repro_torch.obs.report` — end-of-run summary (:func:`summarize` /
  :func:`render_text`).

This package is imported by ``repro_torch.core`` and must never import it back
at module level.
"""

from .metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
    reset_metrics,
    snapshot,
)
from .report import render_text, summarize
from .trace import (
    NOOP,
    Span,
    Tracer,
    configure,
    configured,
    disable,
    export_chrome_trace,
    get_tracer,
    is_enabled,
    load_jsonl,
    span,
    span_end,
    span_start,
    validate_chrome_trace,
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NOOP",
    "Span",
    "Tracer",
    "configure",
    "configured",
    "disable",
    "export_chrome_trace",
    "get_registry",
    "get_tracer",
    "is_enabled",
    "load_jsonl",
    "render_text",
    "reset_metrics",
    "snapshot",
    "span",
    "span_end",
    "span_start",
    "summarize",
    "validate_chrome_trace",
]
