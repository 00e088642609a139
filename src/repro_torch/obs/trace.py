"""Nestable span tracing with a bounded ring, Chrome-trace and JSONL export.

Copy of :mod:`repro.obs.trace` with these changes: spans mirror into
``torch.profiler.record_function`` ranges (``torch_annotations``) where
the reference mirrors its context-manager spans into jax profiler
annotations; here the async spans get a range too, so ``sweep.kernel``
encloses its chunk's kernel launch in a torch profile.  Spans are
stamped in integer nanoseconds from an epoch that is a pair of clocks
(``perf_counter_ns``, ``time_ns``), so :meth:`Tracer.unix_ns` puts them
on the clock of ``torch.profiler``'s events, and each carries its
root's id.  The reference's ``timed_span`` is not ported: nothing here
calls it.

The exploration runtime's stage-level clock: a *span* is a named interval
with wall and CPU duration, structured attributes, and a parent — the
synthesis of chunk 17, generation 42 of an NSGA-II run, one checkpoint
save.  Spans land in a bounded in-memory ring (oldest evicted first) and,
when configured, are appended to a JSONL event log that survives
preemption alongside checkpoints (each line is a complete JSON object
flushed at span end, so a SIGKILL loses at most the spans still open).

Two recording APIs:

* ``with span("synthesize", chunk=i):`` — the common nested form; spans
  nest per thread, and each records its parent and depth.
* ``h = span_start("kernel", chunk=i)`` / ``span_end(h)`` — explicit
  start/stop for work whose begin and end live in different scopes
  (async kernel dispatch: started at dispatch, ended when the stream
  drains the chunk).

**The disabled path is a no-op**: ``span()`` returns a shared singleton
context manager and ``span_start`` returns ``None`` — no allocation, no
clock reads — so instrumented hot loops cost nothing until
:func:`configure` turns tracing on (the reference targets <2% of
*enabled* overhead on a real sweep).

``configure(torch_annotations=True)`` additionally wraps every span in a
``torch.profiler.record_function`` range (an async span's range runs from
``span_start`` to ``span_end``), so the same stage names enclose the
kernel launches in a ``torch.profiler`` trace.

Exports: :func:`export_chrome_trace` writes the standard
``{"traceEvents": [...]}`` Chrome ``trace_event`` document (loadable in
Perfetto / ``chrome://tracing``); :func:`load_jsonl` replays an event
log back into span dicts, tolerating the torn final line a SIGKILL can
leave.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time


class Span:
    """One closed (or still-open) traced interval.  ``start_ns`` and
    ``end_ns`` are integer nanoseconds since the tracer's epoch
    (:meth:`Tracer.unix_ns` puts them on the wall clock); ``root_id`` is
    the outermost open span's id, shared by every span under one root."""

    __slots__ = ("span_id", "parent_id", "root_id", "name", "start_ns",
                 "end_ns", "dur_s", "cpu_dur_s", "tid", "depth", "attrs",
                 "status", "_cpu0_s", "_prof")

    def __init__(self, span_id: int, parent: "Span | None", name: str,
                 start_ns: int, tid: int, depth: int, attrs: dict):
        self.span_id = span_id
        self.parent_id = parent.span_id if parent is not None else None
        self.root_id = parent.root_id if parent is not None else span_id
        self.name = name
        self.start_ns = start_ns
        self.end_ns: int | None = None
        self.dur_s: float | None = None
        self.cpu_dur_s: float | None = None
        self.tid = tid
        self.depth = depth
        self.attrs = attrs
        self.status = "ok"
        self._cpu0_s = time.process_time()
        self._prof = None           # the profiler range of an async span

    @property
    def t0_s(self) -> float:
        """Seconds from the tracer's epoch to the span's start."""
        return self.start_ns / 1e9

    def set(self, **attrs) -> None:
        """Attach/overwrite structured attributes while the span is open."""
        self.attrs.update(attrs)

    def as_dict(self) -> dict:
        return {
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "root_id": self.root_id,
            "name": self.name,
            "t0_s": self.t0_s,
            "dur_s": self.dur_s,
            "cpu_dur_s": self.cpu_dur_s,
            "tid": self.tid,
            "depth": self.depth,
            "status": self.status,
            "attrs": self.attrs,
            "pid": os.getpid(),
        }


class _NoopSpan:
    """Shared do-nothing stand-in returned while tracing is disabled —
    supports the full ``Span`` surface so instrumented code never
    branches on the telemetry switch itself."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass


_NOOP = _NoopSpan()
#: the disabled path's span, for call sites that build attributes only
#: while tracing is on: ``span(name, k=v) if is_enabled() else NOOP``
NOOP = _NOOP


class _SpanCtx:
    """Context-manager wrapper that opens/closes one traced span (and,
    when configured, a ``torch.profiler.record_function`` range of the
    same name)."""

    __slots__ = ("_tracer", "_name", "_attrs", "_span", "_prof_ctx")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self._tracer = tracer
        self._name = name
        self._attrs = attrs
        self._span: Span | None = None
        self._prof_ctx = None

    def __enter__(self) -> Span:
        self._span = self._tracer.start(self._name, self._attrs,
                                        on_stack=True)
        ann = _STATE["torch_annotation"]
        if ann is not None:
            try:
                self._prof_ctx = ann(self._name)
                self._prof_ctx.__enter__()
            except Exception:       # profiler not active / usable
                self._prof_ctx = None
        return self._span

    def __exit__(self, exc_type, exc, tb):
        if self._prof_ctx is not None:
            with contextlib.suppress(Exception):
                self._prof_ctx.__exit__(exc_type, exc, tb)
        self._tracer.end(self._span,
                         status="error" if exc_type is not None else "ok",
                         pop_stack=True)
        return False


class Tracer:
    """Bounded ring of spans plus the per-thread nesting stacks.

    ``ring_size`` bounds memory for marathon runs: the ring keeps the
    newest N *closed* spans (eviction counted in ``n_evicted``), while
    the JSONL log — when configured — keeps everything.

    The epoch is a pair of integer nanosecond clocks read back to back:
    ``perf_counter_ns`` (which stamps the spans) and ``time_ns``, the
    wall clock that ``torch.profiler`` stamps its host and device events
    with; :meth:`unix_ns` converts a span's time to the second.
    """

    def __init__(self, ring_size: int = 65536):
        self.ring_size = int(ring_size)
        self._ring: list[Span] = []
        self._ring_pos = 0
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._set_epoch()
        self.n_recorded = 0
        self.n_evicted = 0

    def _set_epoch(self) -> None:
        # the two clocks drift apart (the wall clock is slewed) by a few
        # microseconds a minute: an epoch read again at each reset of the
        # ring keeps a traced window's conversion within that
        self.epoch_ns = time.perf_counter_ns()
        self.epoch_unix_ns = time.time_ns()

    # -- per-thread nesting ------------------------------------------------
    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def current(self) -> Span | None:
        st = self._stack()
        return st[-1] if st else None

    def unix_ns(self, ns: int) -> int:
        """Nanoseconds since the epoch (a span's ``start_ns`` or
        ``end_ns``) on the wall clock, ``time.time_ns()``'s."""
        return self.epoch_unix_ns + ns

    # -- record ------------------------------------------------------------
    def start(self, name: str, attrs: dict, *,
              on_stack: bool = False) -> Span:
        st = self._stack()
        parent = st[-1] if st else None
        sp = Span(span_id=next(self._ids),
                  parent=parent,
                  name=name,
                  start_ns=time.perf_counter_ns() - self.epoch_ns,
                  tid=threading.get_ident(),
                  depth=len(st),
                  attrs=attrs)
        if on_stack:
            st.append(sp)
        return sp

    def end(self, sp: Span, *, status: str = "ok",
            pop_stack: bool = False) -> None:
        sp.end_ns = time.perf_counter_ns() - self.epoch_ns
        sp.dur_s = (sp.end_ns - sp.start_ns) / 1e9
        sp.cpu_dur_s = time.process_time() - sp._cpu0_s
        sp.status = status
        if pop_stack:
            st = self._stack()
            if st and st[-1] is sp:
                st.pop()
        with self._lock:
            if len(self._ring) < self.ring_size:
                self._ring.append(sp)
            else:
                self._ring[self._ring_pos] = sp
                self._ring_pos = (self._ring_pos + 1) % self.ring_size
                self.n_evicted += 1
            self.n_recorded += 1
        sink = _STATE["jsonl"]
        if sink is not None:
            _write_jsonl(sink, sp)

    # -- read --------------------------------------------------------------
    def spans(self, name: str | None = None) -> list[Span]:
        """Closed spans in end order (oldest surviving first)."""
        with self._lock:
            out = self._ring[self._ring_pos:] + self._ring[:self._ring_pos]
        if name is not None:
            out = [s for s in out if s.name == name]
        return out

    def clear(self) -> None:
        with self._lock:
            self._ring = []
            self._ring_pos = 0
            self.n_recorded = 0
            self.n_evicted = 0
            self._set_epoch()


# ---------------------------------------------------------------------------
# Module state: one process tracer behind one enable switch
# ---------------------------------------------------------------------------

_TRACER = Tracer()
_STATE: dict = {
    "enabled": False,
    "jsonl": None,              # open file object (append mode) or None
    "jsonl_path": None,
    "jsonl_lock": threading.Lock(),
    "torch_annotation": None,   # torch.profiler.record_function if wired
}


def _write_jsonl(sink, sp: Span) -> None:
    line = json.dumps(sp.as_dict(), separators=(",", ":"),
                      default=_json_default)
    with _STATE["jsonl_lock"]:
        sink.write(line + "\n")
        sink.flush()            # each closed span survives a later SIGKILL


def _json_default(o):
    # numpy scalars and other non-JSON attrs degrade to their repr rather
    # than poisoning the whole log line
    try:
        return o.item()
    except Exception:
        return repr(o)


def is_enabled() -> bool:
    return _STATE["enabled"]


def get_tracer() -> Tracer:
    """The process tracer (its ring fills only while tracing is enabled)."""
    return _TRACER


def configure(enabled: bool = True, *,
              jsonl_path=None,
              ring_size: int | None = None,
              torch_annotations: bool = False,
              reset: bool = False) -> None:
    """Flip the process-wide tracing switch.

    ``jsonl_path`` opens (append) a line-per-span event log flushed at
    every span end; ``ring_size`` rebuilds the in-memory ring with a new
    bound; ``torch_annotations`` mirrors every context-manager span into
    ``torch.profiler.record_function`` so stages appear in torch
    profiles; ``reset`` clears
    the ring first.  Disabling closes the JSONL log.
    """
    if ring_size is not None:
        _TRACER.ring_size = int(ring_size)
        _TRACER.clear()
    elif reset:
        _TRACER.clear()
    if _STATE["jsonl"] is not None and (
            not enabled or jsonl_path is None
            or str(jsonl_path) != _STATE["jsonl_path"]):
        with contextlib.suppress(Exception):
            _STATE["jsonl"].close()
        _STATE["jsonl"] = None
        _STATE["jsonl_path"] = None
    if enabled and jsonl_path is not None and _STATE["jsonl"] is None:
        path = os.fspath(jsonl_path)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        _STATE["jsonl"] = open(path, "a", encoding="utf-8")
        _STATE["jsonl_path"] = path
    ann = None
    if enabled and torch_annotations:
        from torch.profiler import record_function as ann
    _STATE["torch_annotation"] = ann
    _STATE["enabled"] = bool(enabled)


def disable() -> None:
    """Turn tracing off and close the JSONL log (ring is kept)."""
    configure(enabled=False)


def check_telemetry(telemetry) -> None:
    """Refuse a ``telemetry`` value :func:`configured` cannot apply: not
    None, a bool or a dict, or a dict naming the reference's
    ``jax_annotations``."""
    if telemetry is not None and not isinstance(telemetry, (bool, dict)):
        raise ValueError(
            "telemetry must be None, a bool, or a dict of "
            "repro_torch.obs.configure() kwargs, got "
            f"{type(telemetry).__name__}")
    if isinstance(telemetry, dict) and "jax_annotations" in telemetry:
        raise ValueError(
            "telemetry key 'jax_annotations' is the JAX package's; the "
            "port mirrors spans into torch.profiler ranges with "
            "'torch_annotations'")


@contextlib.contextmanager
def configured(telemetry):
    """Scoped :func:`configure` for ``ExploreSpec(telemetry=...)``.

    ``None`` leaves the global switch untouched; ``True``/``False`` flip
    it for the duration; a dict is splatted into :func:`configure`
    (e.g. ``{"jsonl_path": ..., "torch_annotations": True}``); a
    dict with the reference's ``jax_annotations`` key is refused.  The prior
    state is restored on exit, so one instrumented ``run()`` never leaks
    its telemetry setup into the next.
    """
    if telemetry is None:
        yield
        return
    prev = {"enabled": _STATE["enabled"],
            "jsonl_path": _STATE["jsonl_path"],
            "torch": _STATE["torch_annotation"] is not None}
    if isinstance(telemetry, dict):
        check_telemetry(telemetry)
        configure(**{"enabled": True, **telemetry})
    else:
        configure(enabled=bool(telemetry))
    try:
        yield
    finally:
        configure(enabled=prev["enabled"],
                  jsonl_path=prev["jsonl_path"],
                  torch_annotations=prev["torch"])


# ---------------------------------------------------------------------------
# Recording API used by instrumented code
# ---------------------------------------------------------------------------

def span(name: str, **attrs):
    """Context manager recording one nested span; a shared no-op while
    tracing is disabled (no allocation, no clock reads)."""
    if not _STATE["enabled"]:
        return _NOOP
    return _SpanCtx(_TRACER, name, attrs)


def span_start(name: str, **attrs) -> Span | None:
    """Open an *un-stacked* span for work that ends in another scope
    (async kernel dispatch).  Returns ``None`` while disabled — pass the
    handle straight to :func:`span_end`, which ignores ``None``."""
    if not _STATE["enabled"]:
        return None
    sp = _TRACER.start(name, attrs)
    ann = _STATE["torch_annotation"]
    if ann is not None:
        try:
            sp._prof = ann(name)
            sp._prof.__enter__()
        except Exception:           # profiler not active / usable
            sp._prof = None
    return sp


def span_end(handle: Span | None, *, status: str = "ok", **attrs) -> None:
    """Close a :func:`span_start` handle (no-op for ``None``)."""
    if handle is None:
        return
    if attrs:
        handle.attrs.update(attrs)
    if handle._prof is not None:
        with contextlib.suppress(Exception):
            handle._prof.__exit__(None, None, None)
        handle._prof = None
    _TRACER.end(handle, status=status)


# ---------------------------------------------------------------------------
# Exporters
# ---------------------------------------------------------------------------

def export_chrome_trace(path=None, *, tracer: Tracer | None = None) -> dict:
    """Render the ring as a Chrome ``trace_event`` document.

    Complete spans become ``"ph": "X"`` duration events (microsecond
    timestamps relative to the tracer epoch); thread ids are remapped to
    small ints in first-seen order so Perfetto's track names stay
    readable.  When ``path`` is given the document is also written there
    as JSON.  Loadable in ``chrome://tracing`` / https://ui.perfetto.dev.
    """
    tr = tracer if tracer is not None else _TRACER
    tid_map: dict[int, int] = {}
    events = []
    for sp in tr.spans():
        tid = tid_map.setdefault(sp.tid, len(tid_map))
        events.append({
            "name": sp.name,
            "cat": "repro",
            "ph": "X",
            "ts": sp.t0_s * 1e6,
            "dur": (sp.dur_s or 0.0) * 1e6,
            "pid": os.getpid(),
            "tid": tid,
            "args": dict(sp.attrs, span_id=sp.span_id,
                         parent_id=sp.parent_id, status=sp.status,
                         cpu_dur_s=sp.cpu_dur_s),
        })
    doc = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "epoch_unix_s": tr.epoch_unix_ns / 1e9,
            "n_recorded": tr.n_recorded,
            "n_evicted": tr.n_evicted,
        },
    }
    if path is not None:
        with open(os.fspath(path), "w", encoding="utf-8") as fh:
            json.dump(doc, fh, default=_json_default)
    return doc


def load_jsonl(path) -> list[dict]:
    """Replay a JSONL event log into span dicts (end order).

    Tolerates the torn final line a SIGKILL can leave mid-write — every
    *complete* line is returned, a trailing partial one is dropped.
    """
    out: list[dict] = []
    with open(os.fspath(path), "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue            # torn tail from a kill mid-write
    return out


def validate_chrome_trace(doc: dict) -> list[str]:
    """Schema check for an exported (or re-loaded) Chrome trace document;
    returns a list of problems (empty = valid)."""
    problems: list[str] = []
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        return ["document is not a dict with a 'traceEvents' key"]
    ev = doc["traceEvents"]
    if not isinstance(ev, list):
        return ["'traceEvents' is not a list"]
    for i, e in enumerate(ev):
        for k in ("name", "ph", "ts", "pid", "tid"):
            if k not in e:
                problems.append(f"event {i} missing {k!r}")
        if e.get("ph") == "X" and "dur" not in e:
            problems.append(f"event {i} is 'X' but has no 'dur'")
        if not isinstance(e.get("ts", 0), (int, float)) \
                or e.get("ts", 0) < 0:
            problems.append(f"event {i} has non-numeric/negative ts")
        if e.get("ph") == "X" and (
                not isinstance(e.get("dur", 0), (int, float))
                or e.get("dur", 0) < 0):
            problems.append(f"event {i} has non-numeric/negative dur")
    return problems
