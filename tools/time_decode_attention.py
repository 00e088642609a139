#!/usr/bin/env python3
"""Time the int8-KV decode attention kernel of one checkout on the GPU.

    python3 tools/time_decode_attention.py [--src DIR] [--tag NAME]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``),
so two checkouts can be timed one after the other on the same card, in
turns A B B A.  For phi4-mini's decode shape (b 4, kvh 8, rep 3, hd 128),
``bs = S`` and every key live, at S 4096 and 32768, with operand sets
rotated past the 50 MB L2, it prints one JSON line per S:

* ``event_ms``: CUDA-event time per call over back-to-back calls (what a
  caller waits for, launch gaps between dependent kernels included);
* ``profiler_ms``: the kernels' device time per call from
  ``torch.profiler`` (their durations summed, gaps left out), the
  largest of three windows, and ``profiler_ops``, the device operations
  per call in that window.
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import sys

SHAPE = (4, 8, 3, 128)          # (b, kvh, rep, hd)
S_VALUES = (4096, 32768)
L2_BYTES = 50 * 2 ** 20


def _profiled(fn, iters: int):
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
    total, ops = 0.0, 0
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0.0)
        if us and ev.count:
            per_call = math.ceil(ev.count / iters)
            total += us / ev.count * per_call
            ops += per_call
    return (total / 1e3 if total else None), ops


def _event_ms(fn, iters: int) -> float:
    import torch
    for i in range(5):
        fn(i)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(pathlib.Path(__file__).resolve()
                                         .parent.parent / "src"))
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import torch
    if not torch.cuda.is_available():
        print("time_decode_attention: CUDA is not available",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import w8a8_decode as D
    device = torch.device("cuda", 0)
    b, kvh, rep, hd = SHAPE
    for S in S_VALUES:
        kv_bytes = 2 * b * S * kvh * (hd + 4)
        copies = -(-2 * L2_BYTES // kv_bytes) + 1
        g = torch.Generator(device).manual_seed(S)
        sets = []
        for _ in range(copies):
            q = torch.randn((b, kvh, rep, hd), generator=g, device=device)
            kq, vq = (torch.randint(-127, 128, (b, S, kvh, hd), generator=g,
                                    device=device, dtype=torch.int32)
                      .to(torch.int8) for _ in range(2))
            ks, vs = (torch.rand((b, S, kvh), generator=g, device=device)
                      * 0.02 + 1e-3 for _ in range(2))
            sets.append((*D.quantize_q(q), kq, vq, ks, vs))
        pos = torch.full((b,), S - 1, dtype=torch.int32, device=device)

        def call(i):
            return D.w8a8_decode_attention_body(*sets[i % copies], pos,
                                                bs=S)
        event_ms = _event_ms(call, 200)
        windows = [_profiled(call, 50) for _ in range(3)]
        prof_ms, ops = max(windows, key=lambda w: w[0] or 0.0)
        print(json.dumps({"tag": args.tag, "src": args.src, "S": S,
                          "event_ms": event_ms, "profiler_ms": prof_ms,
                          "profiler_ops": ops}), flush=True)
        del sets
    return 0


if __name__ == "__main__":
    sys.exit(main())
