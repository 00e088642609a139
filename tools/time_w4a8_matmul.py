#!/usr/bin/env python3
"""Time the W4A8-pow2 matmul kernel of one checkout on the GPU.

    python3 tools/time_w4a8_matmul.py [--src DIR] [--tag NAME] [--m M]
        [--layer phi4|llama] [--shape KxN ...] [--iters N]
        [--regime plan|tc|splitk]
    python3 tools/time_w4a8_matmul.py --generate [--src DIR] [--tag NAME]
    python3 tools/time_w4a8_matmul.py --host [--src DIR] [--tag NAME]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``),
so two checkouts can be timed one after the other on the same card, in
turns A B B A.  At a layer's projection shapes (k, n) with m rows
(default 4, the decode batch), weights rotated past the 50 MB L2 as a
decode step streams them cold, it prints one JSON line per shape and one
for the layer: phi4-mini-3.8b's 7 projections (2 x 3072x3072,
2 x 3072x1024, 2 x 3072x8192, 1 x 8192x3072; the default) or, with
``--layer llama``, llama-3.2-vision-90b's (2 x 8192x8192, 2 x 8192x1024,
2 x 8192x28672, 1 x 28672x8192):

* ``profiler_ms``: the kernel's device time per call from
  ``torch.profiler`` (the smallest of three windows; a window that kept
  no record reads None);
* ``event_ms``: CUDA-event time per call over back-to-back calls;
* ``grid``: the grid the C entry reported for the call (columns / 128,
  row tiles, splits), where the checkout's entry reports it;
* ``regime``: the regime the call ran ("splitk" or "tc"; "splitk" for a
  checkout without the tc regime), and ``equal_plain`` /
  ``equal_splitk``: the output equal bit for bit to the plain version and,
  where the call ran "tc", to the split-k kernel forced on it.

``--shape KxN`` (repeatable) times those shapes instead, once each in
the layer's sum.  A checkout whose wrapper has no ``last_grid`` (before
the split-k kernel) runs the tiled kernel at every m.  ``--regime tc`` or
``splitk`` forces that regime through the wrapper's ``regime`` argument
(checkouts that have one), so both can be timed at ``--m 4096``.

With ``--generate`` it times the W4A8 serving loop instead: phi4-mini-3.8b
at full width in W4A8-pow2, random weights from seed 0, batch 4,
16 prompt + 16 generated tokens through ``launch.serve.generate`` (as
``chip_smoke.py``'s W4A8 serve phase), and prints the decode step's wall
time and the kernel's launches.  With ``--host`` it prints the host time
of one wrapper call and of the steps of its launch path (checks, plan,
stream, workspace, device context, output allocation) at m = 4.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

from time_decode_attention import _event_ms, _profiled

LAYERS = {"phi4": {(3072, 3072): 2, (3072, 1024): 2, (3072, 8192): 2,
                   (8192, 3072): 1},
          "llama": {(8192, 8192): 2, (8192, 1024): 2, (8192, 28672): 2,
                    (28672, 8192): 1}}
L2_BYTES = 50 * 2 ** 20


def _generate(tag: str, src: str) -> None:
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import w4a8_matmul as W4
    from repro_torch.launch.serve import generate
    from repro_torch.models.model import Model
    device = torch.device("cuda", 0)
    cfg = dataclasses.replace(get_config("phi4-mini-3.8b"),
                              quant="w4a8_pow2")
    model = Model(cfg, device=device)
    params = model.init(torch.Generator(device).manual_seed(0),
                        quantize=True)
    prompts = torch.randint(0, cfg.vocab, (4, 16), device=device,
                            generator=torch.Generator(device).manual_seed(1))
    W4.launches = 0
    res = generate(model, params, prompts, gen=16)
    print(json.dumps({"tag": tag, "src": src, "generate": True,
                      "decode_step_ms": res["decode_s"] / 16 * 1e3,
                      "prefill_s": res["prefill_s"],
                      "launches": W4.launches}), flush=True)


def _host(tag: str, src: str) -> None:
    """Host time per call (perf_counter over 2000 calls) of the wrapper
    and of the steps of its launch path, at m = 4, 3072x1024, where the
    host takes longer than the kernel; steps the checkout lacks are
    left out."""
    import time
    import torch
    from repro_torch.kernels import w4a8_matmul as W4
    from repro_torch.kernels import w8a8_matmul as W8
    device = torch.device("cuda", 0)
    m, k, n = 4, 3072, 1024
    x = torch.zeros((m, k), dtype=torch.int8, device=device)
    w = torch.zeros((k // 2, n), dtype=torch.int8, device=device)
    xs, ws = torch.ones((), device=device), torch.ones((n,), device=device)

    def device_context():
        with torch.cuda.device(device):
            pass
    steps = {
        "wrapper": lambda: W4.w4a8_matmul(x, w, xs, ws),
        "check_operands": lambda: W8.check_operands(
            "w4a8_matmul", x, w, xs, ws, packed=True),
        "current_stream": lambda: torch.cuda.current_stream(device)
        .cuda_stream,
        "device_context": device_context,
        "empty": lambda: torch.empty((m, n), dtype=torch.float32,
                                     device=device),
    }
    if hasattr(W4, "plan"):
        steps["plan"] = lambda: W4.plan(m, k, n)
        from repro_torch.kernels._workspace import workspace
        steps["workspace"] = lambda: workspace(device, 1)
    us = {}
    for name, fn in steps.items():
        for _ in range(100):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            fn()
        us[name] = (time.perf_counter() - t0) / 2000 * 1e6
        torch.cuda.synchronize()
    print(json.dumps({"tag": tag, "src": src, "host_us": us}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(pathlib.Path(__file__).resolve()
                                         .parent.parent / "src"))
    ap.add_argument("--tag", default="")
    ap.add_argument("--m", type=int, default=4)
    ap.add_argument("--layer", choices=sorted(LAYERS), default="phi4")
    ap.add_argument("--shape", action="append", default=[])
    ap.add_argument("--regime", choices=("plan", "tc", "splitk"),
                    default="plan")
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--generate", action="store_true")
    ap.add_argument("--host", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import torch
    if not torch.cuda.is_available():
        print("time_w4a8_matmul: CUDA is not available", file=sys.stderr)
        return 1
    if args.generate:
        _generate(args.tag, args.src)
        return 0
    if args.host:
        _host(args.tag, args.src)
        return 0
    from repro_torch.kernels import w4a8_matmul as W4
    device = torch.device("cuda", 0)
    m = args.m
    shapes = ({tuple(int(v) for v in s.split("x")): 1 for s in args.shape}
              or LAYERS[args.layer])
    has_regimes = hasattr(W4, "launches_tc")
    if args.regime != "plan" and not has_regimes:
        print("time_w4a8_matmul: this checkout has one regime",
              file=sys.stderr)
        return 1
    kw = {} if args.regime == "plan" else {"regime": args.regime}
    layer = {"profiler_ms": 0.0, "event_ms": 0.0}
    for (k, n), count in shapes.items():
        copies = -(-2 * L2_BYTES // (k * n // 2)) + 1
        g = torch.Generator(device).manual_seed(k + n)
        x = torch.randint(-127, 128, (m, k), generator=g, device=device,
                          dtype=torch.int32).to(torch.int8)
        ws = [torch.randint(-128, 128, (k // 2, n), generator=g,
                            device=device, dtype=torch.int32)
              .to(torch.int8) for _ in range(copies)]
        xs = torch.rand((), generator=g, device=device) * 0.1 + 1e-3
        wsc = torch.rand((n,), generator=g, device=device) * 0.1 + 1e-3

        def call(i):
            return W4.w4a8_matmul(x, ws[i % copies], xs, wsc, **kw)
        before = getattr(W4, "launches_tc", 0)
        got = call(0)
        regime = "tc" if getattr(W4, "launches_tc", 0) > before \
            else "splitk"
        grid = getattr(W4, "last_grid", None)
        ok = torch.equal(got, W4.w4a8_matmul_ref(x, ws[0], xs, wsc))
        same_splitk = None
        if regime == "tc":
            same_splitk = torch.equal(got, W4.w4a8_matmul(
                x, ws[0], xs, wsc, regime="splitk"))
        event_ms = _event_ms(call, args.iters)
        windows = [_profiled(call, max(1, args.iters // 2))[0]
                   for _ in range(3)]
        got = [w for w in windows if w is not None]
        prof_ms = min(got) if got else None
        row = {"tag": args.tag, "src": args.src, "m": m, "k": k, "n": n,
               "regime": regime,
               "equal_plain": ok, "equal_splitk": same_splitk,
               "event_ms": event_ms, "profiler_ms": prof_ms,
               "profiler_windows": windows, "grid": grid}
        print(json.dumps(row), flush=True)
        layer["event_ms"] += count * event_ms
        layer["profiler_ms"] = (None if prof_ms is None
                                or layer["profiler_ms"] is None
                                else layer["profiler_ms"] + count * prof_ms)
        del ws
    print(json.dumps({"tag": args.tag, "src": args.src, "m": m,
                      "regime": args.regime,
                      "shapes": args.shape or args.layer, "layer": layer}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
