#!/usr/bin/env python3
"""Drive the PyTorch port's design-space sweep on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. build every CUDA kernel of the port from ``src/repro_torch/kernels/csrc``;
2. the main path, through ``repro_torch.core.dse.run``: the paper's
   720-point VGG-16 sweep (per-layer outputs, then aggregates through the
   sweep kernel) and a 1,029,600-config streamed sweep with a running
   Pareto front; the kernel's launch count is read around this phase;
3. parity: the kernel against its plain PyTorch version on the card and
   against the exact float64 CPU path — every chunk of the 102,960-config
   grid, a mixed-precision batch and the VGG-16 + ResNet-34 + ResNet-50
   concatenation — at <= 1e-6 relative, with identical streamed fronts;
4. timing at N = 32768, L = 16 with CUDA events, beside the kernel's
   bound on an H100 (67 TFLOP/s float32, 3.35 TB/s).

The last lines are a ``{"kernels": [...]}`` JSON line, the card's name and
power limit from ``nvidia-smi``, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

RTOL = 1e-6
GRID_FULL = dict(glb_kbs=tuple(2 ** i for i in range(2, 13)),
                 n_bws=156)                       # 102,960 configs
GRID_STREAM = dict(glb_kbs=tuple(2 ** i for i in range(2, 13)),
                   n_bws=1560)                    # 1,029,600 configs
CHUNK = 32768
# H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# float32 operations of the sweep kernel, counted from csrc/sweep_kernel.cu:
# per (config, layer) of the layer loop, and per config outside it
F32_OPS_PER_CELL = 51
F32_OPS_PER_CONFIG = 18


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def grid(spec: dict, chunk_size: int = CHUNK):
    import numpy as np
    from repro_torch.core.accelerator import design_space_soa
    return design_space_soa(chunk_size=chunk_size, glb_kbs=spec["glb_kbs"],
                            bws=tuple(np.linspace(2.0, 64.0, spec["n_bws"])))


def grid_size(spec: dict) -> int:
    # 4 PE types x 5 array shapes x 3 scratchpad scales x GLB x bandwidth
    return 60 * len(spec["glb_kbs"]) * spec["n_bws"]


def rel_err(got, want) -> float:
    import numpy as np
    g = np.asarray(got, dtype=np.float64)
    w = np.asarray(want, dtype=np.float64)
    return float(np.max(np.abs(g - w) / np.maximum(np.abs(w), 1e-30)))


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip()


def phase_build() -> dict:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    paths = _build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in _build.build_log("sweep_kernel").splitlines()
             if "registers" in ln or "spill" in ln]
    return {"phase": "build", "build_s": build_s,
            "libraries": sorted(p.name for p in paths.values()),
            "ptxas": ptxas}


def phase_main_path(device) -> dict:
    """The user's path: run() on the paper space and on a 1M stream."""
    import numpy as np
    from repro_torch.core.dse import DSEPoint, DSEResult, ExploreSpec, run
    from repro_torch.kernels import sweep_kernel

    sweep_kernel.launches = 0
    t0 = time.perf_counter()
    points = run(ExploreSpec.single("vgg16"), device=device)
    t_points = time.perf_counter() - t0
    t0 = time.perf_counter()
    agg = run(ExploreSpec.single("vgg16", outputs="aggregates"),
              device=device)
    t_agg = time.perf_counter() - t0
    t0 = time.perf_counter()
    stream = run(ExploreSpec.single("vgg16", grid(GRID_STREAM),
                                    chunk_size=CHUNK), device=device)
    t_stream = time.perf_counter() - t0
    launches = sweep_kernel.launches

    n_configs = grid_size(GRID_STREAM)
    n_chunks = -(-n_configs // CHUNK)
    check(stream.n_configs == n_configs, "stream config count")
    check(stream.n_chunks == n_chunks, "stream chunk count")
    check(launches >= 1 + n_chunks,
          f"kernel launches on the main path {launches} < {1 + n_chunks}")
    check(stream.front_size > 0, "empty streamed front")
    for m, v in stream.front_metrics.items():
        check(bool(np.all(np.isfinite(v))), f"non-finite front {m}")
    agg_result = DSEResult(agg.workload, [
        DSEPoint(c, agg.result_view(i)) for i, c in enumerate(agg.configs)])
    return {"phase": "main_path", "launches": launches,
            "points_s": t_points, "aggregates_s": t_agg,
            "stream_s": t_stream, "stream_configs": stream.n_configs,
            "stream_chunks": stream.n_chunks,
            "stream_configs_per_s": stream.n_configs / t_stream,
            "stream_timings": stream.timings,
            "stream_front_size": stream.front_size,
            "headline_points": points.headline_ratios(),
            "headline_kernel": agg_result.headline_ratios()}


def phase_headline_exact(main: dict) -> dict:
    """The same 720-point sweep on the exact CPU path."""
    from repro_torch.core.dse import ExploreSpec, run
    exact = run(ExploreSpec.single("vgg16"), device="cpu").headline_ratios()
    errs = {name: max(abs(main[name][k] / v - 1.0) for k, v in exact.items())
            for name in ("headline_points", "headline_kernel")}
    for name, err in errs.items():
        check(err <= RTOL, f"{name} vs exact headline ratios: {err:.3g}")
    return {"phase": "headline_exact", "headline_exact": exact,
            "max_rel_vs_exact": errs}


def _exact_segments(cfg, lay, bounds):
    """Exact float64 CPU aggregates, packed (N, 6W) like the kernel."""
    import numpy as np
    import torch
    from repro_torch.core.dse_batch import (AGGREGATE_OUTPUTS,
                                            _segment_aggregates,
                                            _sweep_kernel, _to_device_inputs)
    ecfg, elay = _to_device_inputs(cfg, lay, torch.device("cpu"), exact=True)
    totals = _sweep_kernel(ecfg, elay, exact=True, outputs="layer_totals")
    seg = _segment_aggregates(totals, ecfg, elay, bounds, exact=True)
    return np.concatenate([seg[k].numpy().T for k in AGGREGATE_OUTPUTS],
                          axis=1)


def _compare(cfg, lay, bounds, device) -> dict:
    """Kernel vs plain version (card) vs exact path (CPU) on one batch."""
    import numpy as np
    import torch
    from repro_torch.core.dse_batch import (AGGREGATE_OUTPUTS,
                                            _cfg_to_device, _lay_to_device)
    from repro_torch.kernels.sweep_kernel import (sweep_aggregates_packed,
                                                  sweep_aggregates_ref)
    cpu = torch.device("cpu")
    dcfg = _cfg_to_device(cfg, device, exact=False)
    kern = sweep_aggregates_packed(dcfg, _lay_to_device(lay, cpu, False),
                                   bounds=bounds).cpu().numpy()
    ref = sweep_aggregates_ref(dcfg, _lay_to_device(lay, device, False),
                               bounds=bounds)
    plain = np.concatenate([ref[k].T.cpu().numpy() for k in
                            AGGREGATE_OUTPUTS], axis=1)
    exact = _exact_segments(cfg, lay, bounds)
    check(kern.shape == exact.shape, "kernel output shape")
    check(bool(np.all(np.isfinite(kern))), "non-finite kernel output")
    return {"rel_vs_plain": rel_err(kern, plain),
            "rel_vs_exact": rel_err(kern, exact),
            "plain_rel_vs_exact": rel_err(plain, exact),
            "max_abs_vs_plain": float(np.max(np.abs(
                kern.astype(np.float64) - plain.astype(np.float64))))}


def phase_parity(device) -> dict:
    import numpy as np
    from repro_torch.core.dse_batch import (_make_cfg_lay, _sweep_chunked,
                                            _workload_batch)
    from repro_torch.core.synthesis import synthesize_soa
    from repro_torch.core.workloads import get_workload
    from repro_torch.core.accelerator import soa_to_configs

    wb = _workload_batch(get_workload("vgg16"))
    results = {"grid": [], "mixed": None, "w3": None}
    first = None
    n_checked = 0
    for soa in grid(GRID_FULL):
        cfg, lay = _make_cfg_lay(soa, synthesize_soa(soa), wb)
        first = first or (soa, cfg)
        results["grid"].append(_compare(cfg, lay, ((0, 16),), device))
        n_checked += len(soa["pe_rows"])
    check(n_checked == grid_size(GRID_FULL), "grid size")

    soa, cfg = first
    rng = np.random.default_rng(20220516)
    n = len(soa["pe_rows"])
    mixed = dict(cfg)
    from repro_torch.core.pe import PEType, pe_spec
    specs = [pe_spec(t) for t in PEType]
    assign = rng.integers(0, len(specs), size=(n, 16))
    mixed["act_bits"] = np.array([s.act_bits for s in specs])[assign]
    mixed["weight_bits"] = np.array([s.weight_bits for s in specs])[assign]
    mixed["mac_energy_pj"] = np.array([s.mac_energy_pj
                                       for s in specs])[assign]
    results["mixed"] = _compare(mixed, lay, ((0, 16),), device)

    wls = [_workload_batch(get_workload(w))
           for w in ("vgg16", "resnet34", "resnet50")]
    lay3 = {k: np.concatenate([w.arrays[k] for w in wls])[None, :]
            for k in wls[0].arrays}
    bounds, s = [], 0
    for w in wls:
        bounds.append((s, s + len(w)))
        s += len(w)
    results["w3"] = _compare(cfg, lay3, tuple(bounds), device)
    results["w3_shape"] = [n, s, len(bounds)]

    every = results["grid"] + [results["mixed"], results["w3"]]
    worst = {k: max(r[k] for r in every) for k in every[0]}
    check(worst["rel_vs_plain"] <= RTOL,
          f"kernel vs plain version {worst['rel_vs_plain']:.3g} > {RTOL}")
    for r in results["grid"] + [results["mixed"]]:
        check(r["rel_vs_exact"] <= RTOL,
              f"kernel vs exact path {r['rel_vs_exact']:.3g} > {RTOL}")
    # On the ResNet segments the float32 policy itself (the plain version,
    # and the reference's jax path alike) strays up to ~2e-6 from the
    # exact path on this grid, so there the kernel is held to the plain
    # version's own distance from it.
    w3 = results["w3"]
    check(w3["rel_vs_exact"] <= max(RTOL, w3["plain_rel_vs_exact"] + RTOL),
          f"W=3 kernel vs exact {w3['rel_vs_exact']:.3g} beyond the "
          f"float32 policy's {w3['plain_rel_vs_exact']:.3g}")

    fronts = {}
    for dev in (device, "cpu"):
        res = _sweep_chunked(get_workload("vgg16"), grid(GRID_FULL),
                             device=dev, chunk_size=CHUNK)
        fronts[str(dev)] = [c.name() for c in res.front_configs()]
    same = fronts[str(device)] == fronts["cpu"]
    check(same, "streamed front on the card differs from the exact path")
    return {"phase": "parity", "configs_checked": n_checked,
            "worst": worst, "mixed": results["mixed"], "w3": results["w3"],
            "w3_shape": results["w3_shape"],
            "front_size": len(fronts["cpu"]), "fronts_identical": same}


def _event_ms(fn, iters: int, warmup: int = 5) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_timing(device) -> dict:
    """Kernel device time vs its plain version at the main path's shape."""
    import torch
    from repro_torch.core.dse_batch import (_cfg_to_device, _lay_to_device,
                                            _make_cfg_lay, _workload_batch)
    from repro_torch.core.synthesis import synthesize_soa
    from repro_torch.core.workloads import get_workload
    from repro_torch.kernels import _build
    from repro_torch.kernels.sweep_kernel import (KERNEL_CFG_FIELDS,
                                                  MIXED_CFG_FIELDS,
                                                  _layer_table,
                                                  sweep_aggregates_packed,
                                                  sweep_aggregates_ref)

    soa = next(iter(grid(GRID_FULL)))
    cfg, lay = _make_cfg_lay(soa, synthesize_soa(soa),
                             _workload_batch(get_workload("vgg16")))
    dcfg = _cfg_to_device(cfg, device, exact=False)
    hlay = _lay_to_device(lay, torch.device("cpu"), exact=False)
    dlay = _lay_to_device(lay, device, exact=False)
    n, l, w = len(soa["pe_rows"]), 16, 1
    bounds = ((0, l),)

    # back-to-back launches of the kernel alone (table built once)
    lib = _build.library("sweep_kernel")
    table = torch.from_numpy(_layer_table(hlay, bounds)).to(device)
    out = torch.empty((n, 6 * w), dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    args = ([ctypes.c_void_p(dcfg[k].data_ptr()) for k in KERNEL_CFG_FIELDS]
            + [ctypes.c_void_p(table.data_ptr()),
               ctypes.c_void_p(out.data_ptr()), n, l, w, l]
            + [int(dcfg[k].shape[1] != 1) for k in MIXED_CFG_FIELDS]
            + [ctypes.c_void_p(stream)])

    def launch():
        err = lib.qappa_sweep_aggregates(*args)
        if err != 0:
            raise RuntimeError(f"launch failed: CUDA error {err}")

    # plain, kernel, kernel, plain: both measured twice within this call
    plain_ms = [_event_ms(lambda: sweep_aggregates_ref(dcfg, dlay), 20)]
    kernel_ms = [_event_ms(launch, 500) for _ in range(2)]
    plain_ms.append(_event_ms(lambda: sweep_aggregates_ref(dcfg, dlay), 20))
    wrapper_ms = _event_ms(lambda: sweep_aggregates_packed(dcfg, hlay), 200)

    profiled_ms = None
    try:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(50):
                launch()
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            if "sweep_aggregates_kernel" in ev.key:
                dev_us = getattr(ev, "device_time", None) or getattr(
                    ev, "cuda_time", 0.0)
                profiled_ms = dev_us / 1e3 if dev_us else None
    except (RuntimeError, AttributeError) as exc:   # tracing unavailable
        print(f"profiler unavailable: {exc}", file=sys.stderr)

    n_read = len(KERNEL_CFG_FIELDS)
    bytes_moved = n * (n_read * 4 + 6 * w * 4) + table.numel() * 4
    ops = n * l * F32_OPS_PER_CELL + n * F32_OPS_PER_CONFIG
    bytes_ms = bytes_moved / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_F32_FLOPS * 1e3
    return {"phase": "timing", "n": n, "l": l, "w": w,
            "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "wrapper_ms": wrapper_ms, "profiled_kernel_ms": profiled_ms,
            "bytes": bytes_moved, "f32_ops": ops, "bytes_ms": bytes_ms,
            "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script measures the "
              "port on an NVIDIA GPU", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    t_start = time.perf_counter()
    smi = nvidia_smi()
    emit(phase_build())
    print(smi, flush=True)
    main_path = phase_main_path(device)
    emit(main_path)
    emit(phase_headline_exact(main_path))
    parity = phase_parity(device)
    emit(parity)
    timing = phase_timing(device)
    emit(timing)
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    emit({"kernels": [{
        "name": "sweep_aggregates",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sweep_kernel.cu",
        "replaces": "src/repro/kernels/sweep_kernel.py:156",
        "launches": main_path["launches"],
        "max_abs_err": parity["worst"]["max_abs_vs_plain"],
        "max_rel_err": parity["worst"]["rel_vs_plain"],
        "ms": min(timing["kernel_ms"]),
        "plain_ms": min(timing["plain_ms"]),
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": None,
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
