"""End-of-run telemetry summary: per-stage time breakdown + derived rates.

Copy of :mod:`repro.obs.report`.

:func:`summarize` folds the span ring and metrics registry into one
machine-readable dict — per-span-name aggregates (count / total / mean /
max wall seconds), the flat metrics snapshot, and the derived numbers a
run is judged by (cache hit rate, evals/s, overlap fraction).
:func:`render_text` pretty-prints that dict for terminal tails of benches
and marathon runs.

Kept import-light on purpose: this module must never drag
``repro_torch.core`` in at import time (core imports
``repro_torch.obs``), and it does not — it only reads the tracer ring and
the registry snapshot.
"""

from __future__ import annotations


def _span_aggregates(spans) -> dict:
    agg: dict = {}
    for sp in spans:
        dur = sp.dur_s or 0.0
        a = agg.get(sp.name)
        if a is None:
            a = agg[sp.name] = {"count": 0, "total_s": 0.0, "max_s": 0.0,
                                "errors": 0}
        a["count"] += 1
        a["total_s"] += dur
        if dur > a["max_s"]:
            a["max_s"] = dur
        if sp.status != "ok":
            a["errors"] += 1
    for a in agg.values():
        a["mean_s"] = a["total_s"] / a["count"] if a["count"] else 0.0
    return dict(sorted(agg.items()))


def _derived(metrics: dict) -> dict:
    d: dict = {}
    hits = metrics.get("synth_cache.hits", 0)
    misses = metrics.get("synth_cache.misses", 0)
    if hits + misses:
        d["synth_cache_hit_rate"] = hits / (hits + misses)
    wall = metrics.get("sweep.wall_s", 0.0)
    if wall:
        d["sweep_configs_per_s"] = metrics.get("sweep.configs", 0) / wall
        synth = metrics.get("sweep.synth_s", 0.0)
        wait = metrics.get("sweep.kernel_wait_s", 0.0)
        # Fraction of host synthesis hidden behind kernel execution: with
        # perfect overlap wall ~= max(synth, kernel), with none it is the
        # sum — so (synth + wait) / wall > 1 means the stages overlapped.
        if synth + wait > 0:
            d["sweep_overlap_fraction"] = max(
                0.0, min(1.0, (synth + wait) / wall - 1.0))
    # device-side throughput: configs over time the kernel was actually
    # executing (busy), not the host wall — the accelerator-bound number
    # the depth-k prefetch queue is trying to saturate
    busy = metrics.get("sweep.kernel_busy_s", 0.0)
    if busy:
        d["sweep_device_configs_per_s"] = (
            metrics.get("sweep.configs", 0) / busy)
    # mean prefetch-queue occupancy: sweep.inflight is a histogram
    # observed once per dispatched chunk; its mean is how many finalize
    # handles the depth-k queue actually kept in flight
    occ_n = metrics.get("sweep.inflight.count", 0)
    if occ_n:
        d["sweep_queue_occupancy_mean"] = (
            metrics.get("sweep.inflight.sum", 0.0) / occ_n)
    ev_s = metrics.get("explore.eval_seconds", 0.0)
    if ev_s:
        d["explore_evals_per_s"] = metrics.get(
            "explore.requested_evals", 0) / ev_s
        d["explore_kernel_evals_per_s"] = metrics.get(
            "explore.kernel_evals", 0) / ev_s
    req = metrics.get("explore.requested_evals", 0)
    memo = metrics.get("explore.memo_hits", 0)
    if req:
        d["explore_memo_hit_rate"] = memo / req
    return d


def summarize(tracer=None, metrics: dict | None = None) -> dict:
    """One dict telling you where the run spent its time.

    ``tracer`` defaults to the process tracer; ``metrics`` defaults to a
    fresh registry :func:`~repro_torch.obs.metrics.snapshot`.  Keys:
    ``spans`` (per-name aggregates), ``metrics`` (flat snapshot),
    ``derived`` (hit rates / rates per second / overlap fraction), and
    ``ring`` (recorded / evicted counts).
    """
    from . import metrics as _m
    from . import trace as _t
    tr = tracer if tracer is not None else _t.get_tracer()
    snap = metrics if metrics is not None else _m.snapshot()
    return {
        "spans": _span_aggregates(tr.spans()),
        "metrics": snap,
        "derived": _derived(snap),
        "ring": {"recorded": tr.n_recorded, "evicted": tr.n_evicted},
    }


def render_text(summary: dict | None = None) -> str:
    """Terminal rendering of :func:`summarize` (pass one, or build fresh)."""
    s = summary if summary is not None else summarize()
    lines = ["== telemetry report =="]
    spans = s.get("spans", {})
    if spans:
        lines.append("-- stages (wall time) --")
        width = max(len(n) for n in spans)
        for name, a in sorted(spans.items(),
                              key=lambda kv: -kv[1]["total_s"]):
            err = f"  errors={a['errors']}" if a.get("errors") else ""
            lines.append(
                f"  {name:<{width}}  n={a['count']:>6}  "
                f"total={a['total_s']:>9.3f}s  mean={a['mean_s']:.4f}s  "
                f"max={a['max_s']:.4f}s{err}")
    derived = s.get("derived", {})
    if derived:
        lines.append("-- derived --")
        for k, v in sorted(derived.items()):
            lines.append(f"  {k}: {v:.4g}" if isinstance(v, float)
                         else f"  {k}: {v}")
    metrics = s.get("metrics", {})
    if metrics:
        lines.append("-- metrics --")
        for k, v in metrics.items():
            lines.append(f"  {k}: {v:.6g}" if isinstance(v, float)
                         else f"  {k}: {v}")
    ring = s.get("ring")
    if ring and ring.get("evicted"):
        lines.append(f"-- ring: {ring['recorded']} recorded, "
                     f"{ring['evicted']} evicted (raise ring_size) --")
    return "\n".join(lines)
