"""The device trace of a traced window and the context the per-layer
metric readers read.

The window runs under ``torch.profiler`` with CUDA activity alone
(recording every PyTorch op on the host as well would slow the host,
which paces the short prompts, and multiply the events).  The device
operations keep their names and times; the harness's own host spans
(drawing a prompt, the ``forward`` call enqueuing its work, the
synchronize and read-back of the logits) are taken on the host's
wall clock, the clock the profiler stamps its events with, and name the
gaps in which the device idles.
"""

from __future__ import annotations

import dataclasses
import functools
import pathlib
import re

#: device activity kinds of the profiler's events that occupy the card
BUSY_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
_GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)")


@functools.lru_cache(maxsize=4096)
def kernel_id(name: str) -> str:
    """A device op's short name: the function of a kernel's demangled
    signature (``void (anonymous namespace)::w4a8_tc_kernel<true>(...)``
    -> ``w4a8_tc_kernel``), other names as they are."""
    short = name.replace("(anonymous namespace)::", "")
    if short.startswith("void "):
        short = short[5:]
    short = re.split(r"[<(]", short, maxsplit=1)[0]
    return short.rsplit("::", 1)[-1].strip() or name


def port_kernel_names(csrc: pathlib.Path) -> frozenset:
    """The names of the program's hand-written kernels: every
    ``__global__`` function of its CUDA sources."""
    names = set()
    for path in sorted(csrc.glob("*.cu*")):
        names.update(_GLOBAL.findall(path.read_text()))
    return frozenset(names)


@dataclasses.dataclass
class DeviceTrace:
    """Device operations ``(kind, name, start_ns, end_ns)`` in start
    order, the traced window ``(start_ns, end_ns)`` and the host spans
    ``(name, start_ns, end_ns)``, all on one clock."""

    ops: list
    window: tuple
    spans: list = dataclasses.field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def kernels(self, kid: str | None = None) -> list:
        """Kernel ops ``(name, start_ns, end_ns)``, those of short name
        ``kid`` alone where given."""
        return [(n, a, b) for k, n, a, b in self.ops if k == "kernel"
                and (kid is None or kernel_id(n) == kid)]

    def busy_intervals(self) -> list:
        """The union of the ops' intervals, clipped to the window."""
        lo, hi = self.window
        out = []
        for kind, _, a, b in sorted(self.ops, key=lambda o: o[2]):
            a, b = max(a, lo), min(b, hi)
            if kind not in BUSY_KINDS or b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def idle_gaps(self) -> list:
        """``(start_ns, end_ns)`` of each stretch of the window in which
        no op runs."""
        gaps, at = [], self.window[0]
        for a, b in self.busy_intervals():
            if a > at:
                gaps.append((at, a))
            at = max(at, b)
        if self.window[1] > at:
            gaps.append((at, self.window[1]))
        return gaps

    def idle_by_span(self) -> dict:
        """Idle seconds by what the host was doing: each gap split over
        the host spans it overlaps, the rest ``between_spans``."""
        spans = sorted(self.spans, key=lambda s: s[1])
        out: dict = {}
        j = 0
        for a, b in self.idle_gaps():
            while j < len(spans) and spans[j][2] <= a:
                j += 1
            rest = b - a
            for name, sa, sb in spans[j:]:
                if sa >= b:
                    break
                overlap = min(b, sb) - max(a, sa)
                if overlap > 0:
                    out[name] = out.get(name, 0.0) + overlap / 1e9
                    rest -= overlap
            if rest > 0:
                out["between_spans"] = out.get("between_spans", 0.0) \
                    + rest / 1e9
        return out

    def op_seconds(self) -> dict:
        """Device seconds by short op name (kernels by function; copies
        and fills by their kind)."""
        out: dict = {}
        for kind, name, a, b in self.ops:
            key = kernel_id(name) if kind == "kernel" else kind
            out[key] = out.get(key, 0.0) + (b - a) / 1e9
        return out


def op_kind(name: str) -> str:
    """A device op's kind from its name: copies and fills are named
    ``Memcpy ...`` and ``Memset ...``, everything else is a kernel."""
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def from_profiler(prof, window: tuple, spans: list) -> DeviceTrace:
    """The device ops of a finished ``torch.profiler.profile`` (the
    profiler's own range annotations left out)."""
    ops = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type().name != "CUDA" or e.is_user_annotation():
            continue
        start = e.start_ns()
        ops.append((op_kind(e.name()), e.name(), start,
                    start + e.duration_ns()))
    ops.sort(key=lambda o: o[2])
    return DeviceTrace(ops=ops, window=window, spans=spans)


@dataclasses.dataclass
class TraceContext:
    """What a per-layer metric's reader gets: the model's shape, the
    prompt lengths and send-to-logits seconds of the traced window's
    requests, its device trace and the program's kernel names."""

    model: object
    lengths: list
    request_s: list
    trace: DeviceTrace
    port_kernels: frozenset


def breakdown(trace: DeviceTrace, n: int = 10) -> dict:
    """The device ops that took most time and the idle time by host
    span, each list the ``n`` largest."""
    ops = sorted(trace.op_seconds().items(), key=lambda kv: -kv[1])[:n]
    gaps = sorted(trace.idle_by_span().items(), key=lambda kv: -kv[1])[:n]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in gaps]}
