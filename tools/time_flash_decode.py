#!/usr/bin/env python3
"""Check and time flash attention's two regimes at decode shapes on the GPU.

    python3 tools/time_flash_decode.py [--src DIR] [--check] [--sweep]
                                       [--sq 1,2,4,8,16,32,64]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``).
``--check`` holds the decode regime (``csrc/flash_decode.cuh``) against
its plain version on both dtypes, rep 1 / 2 / 8, sq up to 16, ragged
key counts, causal, windowed and unmasked rows and a row with no live
key, and prints one JSON line per case.  ``--sweep`` times, at
llama-3.2-vision-90b's decode cross-attention (b 4, h 64, kvh 8, d 128,
1601 keys) and whisper-medium's (b 4, h 16, kvh 16, d 64, 1500 keys),
bf16, for each sq: the decode regime on q, k, v laid out as the model
keeps them ((b, s, heads, d) transposed, k and v at kvh heads); the tile
regime's kernel on the kv heads repeated and transposed to contiguous
copies (``tile``), and the tile regime forced on the model's layout,
which pays for those copies itself (``tile_route``, as ``models/attention
.attend(..., regime="tile")`` runs it); SDPA on the repeated operands and with
``enable_gqa`` on the model's (context only); each with operand sets
rotated past the 50 MB L2, by profiler device time and CUDA events.  One
JSON line per (shape, sq), with the bound: q, k, v read once (k, v at
kvh heads) and out written once at 3.35 TB/s.
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import sys

SHAPES = {"llama": (4, 64, 8, 1601, 128), "whisper": (4, 16, 16, 1500, 64)}
L2_BYTES = 50 * 2 ** 20
HBM_BYTES_S = 3.35e12


def _profiled(fn, iters: int):
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn(0)
    torch.cuda.synchronize()
    best = None
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(i)
            torch.cuda.synchronize()
        total = 0.0
        for ev in prof.key_averages():
            us = getattr(ev, "self_device_time_total", 0.0)
            if us and ev.count:
                total += us / ev.count * math.ceil(ev.count / iters)
        if total:
            best = total / 1e3 if best is None else max(best, total / 1e3)
    return best


def _event_ms(fn, iters: int) -> float:
    import torch
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _operands(b, h, kvh, sq, sk, d, dtype, seed, device):
    """q (b, h, sq, d) and k, v (b, kvh, sk, d) as transposed views of
    (b, s, heads, d) tensors, the model's layout."""
    import torch
    g = torch.Generator(device).manual_seed(seed)
    return [torch.randn((b, s, n, d), generator=g, device=device)
            .to(dtype).transpose(1, 2)
            for s, n in ((sq, h), (sk, kvh), (sk, kvh))]


def check(device) -> list:
    import torch
    from repro_torch.kernels import flash_attention as F
    rows = []
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for (b, h, kvh, d) in ((4, 64, 8, 128), (4, 16, 16, 64),
                               (2, 4, 2, 32), (1, 8, 1, 256),
                               (3, 6, 3, 16)):
            for sq in (1, 2, 5, 8, 16):
                for sk in (1, 7, 1500, 1601, 4099):
                    for causal, window in ((False, None), (True, None),
                                           (True, 37), (False, 300)):
                        cases.append((dtype, b, h, kvh, sq, sk, d, causal,
                                      window))
    # rows with no live key: causal with sq > sk
    for dtype in (torch.float32, torch.bfloat16):
        cases += [(dtype, 2, 8, 2, 9, 3, 64, True, None),
                  (dtype, 2, 8, 2, 16, 7, 128, True, 4)]
    for i, (dtype, b, h, kvh, sq, sk, d, causal, window) in enumerate(cases):
        q, k, v = _operands(b, h, kvh, sq, sk, d, dtype, i, device)
        row = {"dtype": str(dtype), "shape": [b, h, kvh, sq, sk, d],
               "causal": causal, "window": window}
        try:
            got = F.flash_attention(q, k, v, causal=causal, window=window,
                                    regime="decode")
        except RuntimeError as exc:
            rows.append(dict(row, ok=False, error=str(exc)[:200]))
            continue
        want = F.flash_attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        gf, wf = got.float(), want.float()
        err = float((gf - wf).abs().max())
        if dtype == torch.float32:
            ok = err <= 1e-5 * max(float(wf.abs().max()), 1e-30)
            ulps = None
        else:
            ok = bool(((gf - wf).abs() <= 2e-2 * (1 + wf.abs())).all())
            row_max = wf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30)
            ok &= bool(((gf - wf).abs() <= 2.0 ** -6 * row_max).all())
            # bf16 outputs more than one bf16 ulp off the plain version
            ulp = torch.where(wf == 0, torch.full_like(wf, 2.0 ** -133),
                              2.0 ** (torch.floor(torch.log2(wf.abs()))
                                      - 7))
            ulps = int(((gf - wf).abs() > ulp).sum())
        rows.append(dict(row, max_abs=err, ok=ok, bf16_over_1ulp=ulps,
                         grid=list(F.last_grid)))
    return rows


def sweep(device, sqs) -> list:
    import torch
    import torch.nn.functional as NF
    from repro_torch.kernels import flash_attention as F
    out = []
    for name, (b, h, kvh, sk, d) in SHAPES.items():
        for sq in sqs:
            dtype = torch.bfloat16
            nbytes = 2 * (2 * sq * h + 2 * sk * kvh) * b * d
            copies = -(-2 * L2_BYTES // nbytes) + 1
            sets = [_operands(b, h, kvh, sq, sk, d, dtype, 10 + c, device)
                    for c in range(copies)]
            tiles = [[t.contiguous() for t in
                      (q, F.broadcast_kv(k, h), F.broadcast_kv(v, h))]
                     for q, k, v in sets]
            fns = {
                "decode": lambda i: F.flash_attention(
                    *sets[i % copies], causal=False, regime="decode"),
                "tile": lambda i: F.flash_attention(
                    *tiles[i % copies], causal=False, regime="tile"),
                "tile_route": lambda i: F.flash_attention(
                    *sets[i % copies], causal=False, regime="tile"),
                "sdpa_repeated": lambda i: NF.scaled_dot_product_attention(
                    *tiles[i % copies]),
                "sdpa_gqa": lambda i: NF.scaled_dot_product_attention(
                    *sets[i % copies], enable_gqa=True),
                "plain": lambda i: F.flash_attention_ref(
                    *sets[i % copies], causal=False),
            }
            row = {"shape": name, "b": b, "h": h, "kvh": kvh, "sq": sq,
                   "sk": sk, "d": d, "copies": copies,
                   "bound_ms": nbytes / HBM_BYTES_S * 1e3,
                   "plan": F.decode_plan(b, h, kvh, sq, sk, d, dtype,
                                         causal=False, window=None)._asdict()}
            for key, fn in fns.items():
                iters = 3 if key == "plain" else 50
                try:
                    row[f"{key}_ms"] = _profiled(fn, iters)
                    row[f"{key}_event_ms"] = _event_ms(fn, iters)
                except (RuntimeError, TypeError) as exc:
                    row[f"{key}_error"] = str(exc)[:200]
            got = F.flash_attention(*sets[0], causal=False, regime="decode")
            want = F.flash_attention_ref(*sets[0], causal=False)
            row["decode_max_abs_vs_plain"] = float(
                (got.float() - want.float()).abs().max())
            out.append(row)
            del sets, tiles
            torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(pathlib.Path(__file__).resolve()
                                         .parents[1] / "src"))
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--sq", default="1,2,4,8,16,32,64")
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import torch
    if not torch.cuda.is_available():
        print("time_flash_decode: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    device = torch.device("cuda", 0)
    _build.build_all(["flash_decode", "flash_decode_f32"])
    print(json.dumps({"ptxas": [
        ln.strip() for name in ("flash_decode", "flash_decode_f32")
        for ln in _build.build_log(name).splitlines()
        if "registers" in ln or "spill" in ln or "Compiling" in ln]}),
        flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0)}), flush=True)
    failed = 0
    if args.check:
        for row in check(device):
            failed += not row["ok"]
            print(json.dumps(row), flush=True)
    if args.sweep:
        for row in sweep(device, [int(s) for s in args.sq.split(",")]):
            print(json.dumps(row), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
