"""A cell's kernel time split by the program span that launched each
kernel, and what the port's tracing costs, on the card.

    python3 portbench/tools/spans.py --workload <cell> --seed <n> \
        --seconds <s> [--out FILE]

In one process: the program set up as a run sets it up, one request
served with the port's tracing off and on (its logits compared bit for
bit), then two windows of the cell's closed loop: for ``2 x --seconds``
the port's tracing on for every other request, so that traced and
untraced requests of each length meet the card in the same state; then
for ``--seconds`` the tracer on under ``torch.profiler`` with CUDA
activity, as a ``--trace 1`` run profiles.  Each kernel of the profiled
window is put down to the innermost span open on the host at its launch
(``repro_torch.obs.attribution``).

Prints one JSON object: of the traced and the untraced requests apart
their prompt tokens a second and, by length, the host seconds of a
``forward`` call (its enqueue) and of a request; and of the profiled
window the PyTorch kernels' seconds by innermost span, the six
shares of the window's kernel time (``SHARES``), the benchmark's own
readers on the same trace, the idle seconds inside each forward by the
innermost span open on the host, the kernels launched outside every
span, and how the shares move with the launches shifted by the clocks'
uncertainty.
"""

import argparse
import bisect
import gc
import json
import pathlib
import statistics
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from portbench.harness import devtrace, guard, main, program  # noqa: E402
from portbench.harness import spec  # noqa: E402
from repro_torch.obs import attribution  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402

#: each share's spans: the PyTorch kernels whose innermost span is one of
#: them; ``None`` takes those under a ``model.forward`` root that no
#: other share takes (residual adds, SwiGLU's product, embedding, logits)
SHARES = {
    "act_quant_share": {"qlinear.act_quant"},
    "qlinear_cast_share": {"qlinear.out_cast"},
    "norm_share": {"common.rms_norm"},
    "rope_share": {"common.rope"},
    "attn_glue_share": {"attn.self"},
    "block_rest_share": None,
}
#: spans a window may hold: ~900 a forward of 32 layers, ~40 forwards
RING = 1 << 21
#: idle gaps shorter than this inside a forward are the device's own
#: bubbles between kernels, not waits on the host, and are summed apart
BUBBLE_NS = 20_000
#: the readers run on the profiled window, for comparison
READERS = ("torch_op_share", "kernel_launches_per_ktok",
           "device_idle_share")


def window(st: main.Setup, seconds: float, *, alternate: bool,
           profile: bool = False) -> dict:
    """The closed loop for ``seconds`` with the port's tracing on (for
    every other request, from the second, where ``alternate``): each
    request's length, host seconds of its ``forward`` call, seconds from
    send to logits and whether it was traced, and (``profile``) the
    profile and the calls' ``(start_ns, end_ns)`` on the wall clock."""
    obs_trace.configure(enabled=False, ring_size=RING)
    prof = None
    if profile:
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        prof.start()
    calls, lengths, sent, traced = [], [], [], []
    gc.collect()
    gc.disable()
    try:
        with torch.no_grad():
            w0 = time.time_ns()
            start = time.perf_counter()
            for i, (length, offset) in enumerate(st.schedule):
                if time.perf_counter() >= start + seconds:
                    break
                traced.append(not alternate or i % 2 == 1)
                obs_trace.configure(enabled=traced[-1])
                tokens = st.pool[offset:offset + length]
                a = time.time_ns()
                out = program.serve(st.model, st.params, tokens)
                b = time.time_ns()
                out.to("cpu")
                calls.append((a, b))
                lengths.append(length)
                sent.append(time.time_ns() - a)
            w1 = time.time_ns()
    finally:
        gc.enable()
        obs_trace.disable()
    if prof is not None:
        prof.stop()
    tracer = obs_trace.get_tracer()
    return {"lengths": lengths, "traced": traced,
            "forward_host_s": [(b - a) / 1e9 for a, b in calls],
            "request_s": [ns / 1e9 for ns in sent],
            "calls": calls, "window": (w0, w1), "prof": prof,
            "n_spans": tracer.n_recorded, "n_evicted": tracer.n_evicted,
            # the clocks' drift across the window: wall minus perf
            "drift_ns": (time.time_ns() - tracer.epoch_unix_ns)
            - (time.perf_counter_ns() - tracer.epoch_ns)}


def share_of(span: attribution.WallSpan | None, roots: dict) -> str | None:
    """The share a kernel launched in ``span`` counts in, or None."""
    if span is None or roots.get(span.root_id) != "model.forward":
        return None
    for share, names in SHARES.items():
        if names is not None and span.name in names:
            return share
    return "block_rest_share"


def shares(runs: list, spans: list, port: frozenset,
           shift_ns: int = 0) -> dict:
    """Each share in % of the window's kernel time, with the launches
    shifted by ``shift_ns``."""
    roots = {s.span_id: s.name for s in spans if s.span_id == s.root_id}
    shifted = [attribution.Kernel(k.name, k.start_ns, k.end_ns,
                                  None if k.launch_ns is None
                                  else k.launch_ns + shift_ns) for k in runs]
    total = sum(k.seconds for k in runs)
    out = {name: 0.0 for name in SHARES}
    for k, span in zip(shifted, attribution.owners(shifted, spans)):
        if devtrace.kernel_id(k.name) in port:
            continue
        share = share_of(span, roots)
        if share is not None:
            out[share] += 100.0 * k.seconds / total
    return out


def split(cell: spec.Cell, win: dict) -> dict:
    """The profiled window's readings (None where it ran no kernel, or
    where the ring evicted a span)."""
    import repro_torch.kernels
    port = devtrace.port_kernel_names(
        pathlib.Path(repro_torch.kernels.__file__).parent / "csrc")
    spans = attribution.wall_spans()
    runs = attribution.kernels(win["prof"])
    if not runs or win["n_evicted"]:
        return None
    pytorch = [k for k in runs if devtrace.kernel_id(k.name) not in port]
    by_span = attribution.seconds_by_span(pytorch, spans)
    launched = attribution.seconds_by_span(runs, spans)
    counts: dict = {}
    for span in attribution.owners(runs, spans):
        key = span.name if span is not None else None
        counts[key] = counts.get(key, 0) + 1
    trace = devtrace.from_profiler(
        win["prof"], win["window"],
        [("forward_enqueue", a, b) for a, b in win["calls"]])
    ctx = devtrace.TraceContext(
        model=cell.model, lengths=win["lengths"], request_s=[],
        trace=trace, port_kernels=port)
    stretches = attribution.Stretches(spans)
    calls = win["calls"]
    starts = [a for a, _ in calls]
    idle: dict = {}
    bubbles = 0.0    # gaps under BUBBLE_NS: between kernels, not the host
    for a, b in trace.idle_gaps():
        i = bisect.bisect_right(starts, b) - 1
        while i >= 0 and calls[i][1] > a:
            lo, hi = max(a, calls[i][0]), min(b, calls[i][1])
            if lo < hi and b - a < BUBBLE_NS:
                bubbles += (hi - lo) / 1e9
            elif lo < hi:
                for name, ns in stretches.split(lo, hi).items():
                    idle[str(name)] = idle.get(str(name), 0.0) + ns / 1e9
            i -= 1
    bound = max(abs(win["drift_ns"]), 2_500)
    base = shares(runs, spans, port)
    moved = [shares(runs, spans, port, s) for s in (-bound, bound)]
    return {
        "shares": base,
        "shares_sum": sum(base.values()),
        "readers": {n: main.load_reader(n)(ctx) for n in READERS},
        "pytorch_s_by_span": {str(k): v for k, v in sorted(
            by_span.items(), key=lambda kv: -kv[1])} if by_span else None,
        "all_s_by_span": {str(k): v for k, v in sorted(
            launched.items(), key=lambda kv: -kv[1])} if launched else None,
        "launches_by_span": {str(k): v for k, v in sorted(
            counts.items(), key=lambda kv: -kv[1])},
        "kernels": len(runs), "kernels_without_launch": sum(
            k.launch_ns is None for k in runs),
        "kernel_s": sum(k.seconds for k in runs),
        "idle_in_forward": dict(sorted(idle.items(), key=lambda kv: -kv[1])),
        "idle_in_forward_bubbles_s": bubbles,
        "idle_s": sum(b - a for a, b in trace.idle_gaps()) / 1e9,
        "shift_ns": bound,
        "shares_moved_by_shift": max(abs(m[n] - base[n]) for m in moved
                                     for n in base),
        "forward_span_s": [(s.end_ns - s.start_ns) / 1e9 for s in spans
                           if s.name == "model.forward"],
    }


def bit_identical(st: main.Setup) -> bool:
    """One request's logits with the port's tracing off and on."""
    tokens = st.pool[:min(st.schedule.base)]
    with torch.no_grad():
        off = program.serve(st.model, st.params, tokens).to("cpu")
        obs_trace.configure(enabled=True, reset=True)
        try:
            on = program.serve(st.model, st.params, tokens).to("cpu")
        finally:
            obs_trace.disable()
    return bool(torch.equal(off, on)) and obs_trace.get_tracer().n_recorded > 0


def summary(win: dict) -> dict:
    """A window's traced and untraced requests apart: prompt tokens over
    the requests' seconds, and by prompt length the medians of a
    ``forward`` call's host seconds and of a request's seconds."""
    out = {"n_spans": win["n_spans"], "n_evicted": win["n_evicted"],
           "drift_ns": win["drift_ns"]}
    for side in (False, True):
        rows = [r for r in zip(win["lengths"], win["forward_host_s"],
                               win["request_s"], win["traced"])
                if r[3] == side]
        by_len: dict = {}
        for n, host, req, _ in rows:
            by_len.setdefault(n, []).append((host, req))
        out["on" if side else "off"] = {
            "requests": len(rows),
            "tokens_s": sum(r[0] for r in rows) / sum(r[2] for r in rows)
            if rows else None,
            "by_length": {n: {"forward_host_s": statistics.median(
                h for h, _ in v), "request_s": statistics.median(
                r for _, r in v), "requests": len(v)}
                for n, v in sorted(by_len.items())}}
    return out


def run(cell: spec.Cell, seed: int, seconds: float, device) -> dict:
    st = main.set_up(cell, seed, device)
    out = {"workload": cell.name, "seed": seed, "seconds": seconds,
           "device": torch.cuda.get_device_name(device),
           "power_limit": main.power_limit(),
           "bit_identical": bit_identical(st)}
    out["cost"] = summary(window(st, 2 * seconds, alternate=True))
    win = window(st, seconds, alternate=False, profile=True)
    out["profiled"] = summary(win)
    out["split"] = split(cell, win)
    return out


def cli(argv: list) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", type=pathlib.Path)
    args = ap.parse_args(argv)
    guard.pin_caches(spec.ROOT)
    cell = spec.load_cell(args.workload)
    result = run(cell, args.seed, args.seconds,
                 guard.require_cards(cell.chips))
    line = json.dumps(result)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(cli(sys.argv[1:]))
