"""One run of one cell: set-up, the measured window, the trace's metrics,
the output check, and the result's line.

Set-up draws the weights on the card from the seed, has the port
quantize them, makes the token pool and serves one request at the mix's
longest and one at its shortest prompt (the first builds the port's
kernels where the checkout has none yet).  The window is a closed loop:
one client sends the next prompt once the last one's logits are on the
host, for ``--seconds``; the requests sent before the window's end all
finish and count.  After the window the program is freed and the plain
reference computes the logits of a sample of the finished requests
again, the longest among them, from the same weights and prompts.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

from portbench.harness import devtrace, guard, program, spec, traffic
from portbench.reference.dense import Reference, numbers

#: traced window's host spans
SPAN_DRAW, SPAN_ENQUEUE, SPAN_READBACK = ("draw_prompt", "forward_enqueue",
                                          "sync_readback")


@dataclasses.dataclass
class Request:
    length: int
    offset: int
    sent: float          # host clock, s
    done: float          # logits on the host
    logits: torch.Tensor  # on the host, as served

    @property
    def seconds(self) -> float:
        return self.done - self.sent


@dataclasses.dataclass
class Window:
    start: float
    requests: list
    trace: devtrace.DeviceTrace | None = None

    @property
    def seconds(self) -> float:
        return self.requests[-1].done - self.start

    @property
    def tokens(self) -> int:
        return sum(r.length for r in self.requests)


@dataclasses.dataclass
class Setup:
    model: object
    params: dict
    pool: torch.Tensor
    schedule: traffic.Schedule


def set_up(cell: spec.Cell, seed: int, device, impl: str = "auto") -> Setup:
    """The program with its weights, the token pool and the schedule,
    every shape of the mix's traffic served once."""
    model, params = program.build(cell.model, seed, device, impl)
    pool = traffic.token_pool(seed, cell.model.vocab, device)
    schedule = traffic.Schedule(cell.traffic, seed)
    with torch.no_grad():
        for s in (max(schedule.base), min(schedule.base)):
            program.serve(model, params, pool[:s]).to("cpu")
    return Setup(model, params, pool, schedule)


def serve_window(st: Setup, seconds: float, *, trace: bool = False,
                 requests: list | None = None) -> Window:
    """The closed loop for ``seconds`` (or over ``requests``, a list of
    ``(length, offset)``, where given); with ``trace`` under the
    profiler, with the host spans on the profiler's clock."""
    spans: list = []
    prof = None
    if trace:
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        prof.start()

    def span(name, a):
        if trace:
            spans.append((name, a, time.time_ns()))

    done: list = []
    todo = iter(requests) if requests is not None else st.schedule
    gc.collect()
    gc.disable()
    try:
        with torch.no_grad():
            start = time.perf_counter()
            w0 = time.time_ns()
            deadline = start + seconds
            for length, offset in todo:
                if requests is None and time.perf_counter() >= deadline:
                    break
                a = time.time_ns() if trace else 0
                tokens = st.pool[offset:offset + length]
                span(SPAN_DRAW, a)
                sent = time.perf_counter()
                a = time.time_ns() if trace else 0
                out = program.serve(st.model, st.params, tokens)
                span(SPAN_ENQUEUE, a)
                a = time.time_ns() if trace else 0
                host = out.to("cpu")
                span(SPAN_READBACK, a)
                done.append(Request(length, offset, sent,
                                    time.perf_counter(), host))
            w1 = time.time_ns()
    finally:
        gc.enable()
    win = Window(start, done)
    if prof is not None:
        prof.stop()
        win.trace = devtrace.from_profiler(prof, (w0, w1), spans)
    return win


def sample(requests: list, k: int, seed: int) -> list:
    """Indices of ``k`` finished requests drawn from the seed: the first
    of the longest, and ``k - 1`` others."""
    longest = max(range(len(requests)), key=lambda i: requests[i].length)
    rest = [i for i in range(len(requests)) if i != longest]
    pick = traffic.rng(seed, 3).permutation(len(rest))[:max(0, k - 1)]
    return [longest] + sorted(rest[i] for i in pick)


def reference_logits(shape: spec.ModelShape, seed: int, prompts: list,
                     device, *, act_bits: int = 8,
                     weight_bits: int = 8) -> list:
    """The plain reference's last logits of ``prompts``, float32 matmuls
    in full float32 (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.no_grad():
        return Reference(shape, act_bits=act_bits,
                         weight_bits=weight_bits).last_logits(
            seed, prompts, device)


def check(cell: spec.Cell, seed: int, win: Window, pool: torch.Tensor,
          device) -> dict:
    """Each compared number of the sampled requests beside its limit."""
    idx = sample(win.requests, int(cell.traffic["check_requests"]), seed)
    prompts = [pool[win.requests[i].offset:
                    win.requests[i].offset + win.requests[i].length]
               for i in idx]
    ref = reference_logits(cell.model, seed, prompts, device)
    nums = numbers([win.requests[i].logits for i in idx], ref)
    return {name: {"value": nums[name], "limit": limit}
            for name, limit in sorted(cell.limits["limits"].items())}


def percentile(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def end_to_end(name: str, win: Window, setup_s: float,
               peak_bytes: int) -> float:
    if name == "prefill_tok_s":
        return win.tokens / win.seconds
    if name == "ttft_p95_ms":
        return 1000.0 * percentile([r.seconds for r in win.requests], 95)
    if name == "peak_mem_gib":
        return peak_bytes / 2 ** 30
    if name == "setup_s":
        return setup_s
    raise KeyError(f"no end-to-end metric {name!r} in the harness")


def load_reader(name: str):
    """The ``read(ctx)`` of ``metrics/<name>.py``."""
    path = spec.BENCH_DIR / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def per_layer(cell: spec.Cell, win: Window) -> dict:
    """Each per-layer metric whose reader finds something to read."""
    import repro_torch.kernels
    csrc = pathlib.Path(repro_torch.kernels.__file__).parent / "csrc"
    ctx = devtrace.TraceContext(
        model=cell.model, lengths=[r.length for r in win.requests],
        request_s=[r.seconds for r in win.requests], trace=win.trace,
        port_kernels=devtrace.port_kernel_names(csrc))
    out = {}
    for m in cell.per_layer:
        value = load_reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        got = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True)
    except (OSError, subprocess.SubprocessError) as err:
        return f"not read ({type(err).__name__})"
    return got.stdout.strip().splitlines()[0]


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, *,
        t0: float, device=None) -> dict:
    """One run's result line as a dict (``check`` last).  ``device``
    None: the card, :class:`guard.NoDevice` where there is none."""
    dev = device if device is not None else guard.require_cards(cell.chips)
    on_card = torch.device(dev).type == "cuda"
    st = set_up(cell, seed, dev)
    if on_card:
        torch.cuda.synchronize(dev)
        setup_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    win_start = time.perf_counter()
    setup_s = win_start - t0
    win = serve_window(st, seconds, trace=trace)
    window_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    failed = sum(not bool(torch.isfinite(r.logits).all())
                 for r in win.requests)
    if trace:
        metrics = per_layer(cell, win)
    else:
        metrics = {m["name"]: {"value": end_to_end(m["name"], win, setup_s,
                                                   window_peak),
                               "unit": m["unit"]}
                   for m in cell.end_to_end}
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if on_card
                   else "cpu",
                   "count": cell.chips,
                   "memory_peak_bytes": max(setup_peak, window_peak)
                   if on_card else 0}
    if trace and win.trace is not None:
        device_info.update(busy_s=win.trace.busy_s(),
                           window_s=win.trace.window_s)
    if on_card:
        device_info["power_limit"] = power_limit()
    pool = st.pool
    del st
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    compared = check(cell, seed, win, pool, dev)
    result = {"correct": failed == 0 and all(
                  c["value"] <= c["limit"] for c in compared.values()),
              "attempted": len(win.requests), "failed": failed,
              "metrics": metrics, "device": device_info}
    if trace and win.trace is not None:
        result["breakdown"] = devtrace.breakdown(win.trace)
    result["check"] = compared
    return result


def cli(argv: list, t0: float) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (spec.ROOT / "src" / "repro_torch").is_dir():
        print("portbench: the program (src/repro_torch) is not in this "
              "checkout", file=sys.stderr)
        return 2
    guard.pin_caches(spec.ROOT)
    cell = spec.load_cell(args.workload)
    try:
        result = run(cell, args.seed, args.seconds, bool(args.trace), t0=t0)
    except guard.NoDevice as err:
        print(f"portbench: {err}", file=sys.stderr)
        return 2
    found = guard.forbidden_modules()
    if found:
        print(f"portbench: the run holds forbidden modules {found}",
              file=sys.stderr)
        return 3
    for name, c in result["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result, allow_nan=True))
    return 0
