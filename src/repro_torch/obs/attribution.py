"""Device kernels put down to the program spans that launched them.

A window traced by ``torch.profiler`` with CUDA activity holds each
kernel's run on the device and the host call that launched it
(``cudaLaunchKernel``, ``cuLaunchKernelEx``, ...), linked by one
correlation id, both on the wall clock (``time.time_ns``).  A CUDA-only
profile records no ``record_function`` ranges, so the spans come from
the tracer (:mod:`repro_torch.obs.trace`), put on the same clock by
:meth:`~repro_torch.obs.trace.Tracer.unix_ns`: a kernel belongs to the
innermost span open on the host when it was launched.

The spans are taken to nest, as the spans of one thread do; they are
flattened into :class:`Stretches`, each the stretch of host time in
which one span is the innermost open one.
"""

from __future__ import annotations

import bisect
import dataclasses

from repro_torch.obs import trace as obs_trace


@dataclasses.dataclass(frozen=True)
class WallSpan:
    """A closed span on the wall clock: ``start_ns`` / ``end_ns`` as
    ``time.time_ns()`` reads them."""

    name: str
    start_ns: int
    end_ns: int
    span_id: int
    root_id: int


@dataclasses.dataclass(frozen=True)
class Kernel:
    """One kernel's run on the device and its host launch
    (``launch_ns``; None where the trace holds no launch call)."""

    name: str
    start_ns: int
    end_ns: int
    launch_ns: int | None

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


def wall_spans(tracer: obs_trace.Tracer | None = None) -> list[WallSpan]:
    """The tracer's closed spans on the wall clock, in end order."""
    tr = tracer if tracer is not None else obs_trace.get_tracer()
    return [WallSpan(sp.name, tr.unix_ns(sp.start_ns), tr.unix_ns(sp.end_ns),
                     sp.span_id, sp.root_id) for sp in tr.spans()]


def kernels(prof) -> list[Kernel]:
    """The kernels of a finished ``torch.profiler.profile`` in start
    order, each with the start of the host call that launched it (the
    CPU event of the same correlation id: the CUDA API's ``cu*`` calls,
    which a CUDA-only profile records)."""
    launches, runs = {}, []
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            continue
        if e.device_type().name == "CUDA":
            if not e.name().startswith(("Memcpy", "Memset")):
                runs.append(e)
        elif e.name().startswith("cu") and e.correlation_id():
            launches[e.correlation_id()] = e.start_ns()
    out = [Kernel(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
                  launches.get(e.correlation_id()) if e.correlation_id()
                  else None) for e in runs]
    out.sort(key=lambda k: k.start_ns)
    return out


class Stretches:
    """Nested spans flattened: sorted, disjoint ``(start, end, span)``
    stretches, each where ``span`` is the innermost open span."""

    def __init__(self, spans: list):
        order = sorted(spans, key=lambda s: (s.start_ns, -s.end_ns))
        out, stack, at = [], [], None

        def close(upto):
            nonlocal at
            while stack and stack[-1].end_ns <= upto:
                top = stack.pop()
                if top.end_ns > at:
                    out.append((at, top.end_ns, top))
                at = max(at, top.end_ns)

        for s in order:
            close(s.start_ns)
            if stack and s.start_ns > at:
                out.append((at, s.start_ns, stack[-1]))
            stack.append(s)
            at = s.start_ns
        close(float("inf"))
        self.stretches = out
        self._starts = [a for a, _, _ in out]

    def at(self, t: int | None):
        """The innermost span open at ``t``, or None."""
        if t is None:
            return None
        i = bisect.bisect_right(self._starts, t) - 1
        if i >= 0 and t < self.stretches[i][1]:
            return self.stretches[i][2]
        return None

    def split(self, a: int, b: int) -> dict:
        """Nanoseconds of ``[a, b)`` under each innermost span (keyed by
        name), the rest under None."""
        out: dict = {}
        rest = b - a
        i = max(0, bisect.bisect_right(self._starts, a) - 1)
        for sa, sb, span in self.stretches[i:]:
            if sa >= b:
                break
            overlap = min(b, sb) - max(a, sa)
            if overlap > 0:
                out[span.name] = out.get(span.name, 0) + overlap
                rest -= overlap
        if rest > 0:
            out[None] = out.get(None, 0) + rest
        return out


def owners(runs: list[Kernel], spans: list[WallSpan]) -> list:
    """Each kernel's innermost span at its launch (None: launched
    outside every span, or no launch in the trace)."""
    st = Stretches(spans)
    return [st.at(k.launch_ns) for k in runs]


def seconds_by_span(runs: list[Kernel], spans: list[WallSpan],
                    n_evicted: int = 0) -> dict | None:
    """Kernel seconds by the name of the innermost span that launched
    them, None for the kernels no span launched.  None where the ring
    evicted a span (what it launched would be put down to its parent) or
    holds no spans."""
    if n_evicted or not spans:
        return None
    out: dict = {}
    for k, span in zip(runs, owners(runs, spans)):
        key = span.name if span is not None else None
        out[key] = out.get(key, 0.0) + k.seconds
    return out
