#!/usr/bin/env python3
"""Time the sweep aggregate kernel of one checkout on the GPU.

    python3 tools/time_sweep_kernel.py [--src DIR] [--tag NAME] [--iters N]
    python3 tools/time_sweep_kernel.py --stream [--src DIR] [--tag NAME]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``),
so two checkouts can be timed one after the other on the same card, in
turns A B B A.  At three shapes of N = 32768 configs (the first chunk of
the 102,960-config VGG-16 grid of ``chip_smoke.py``):

* ``vgg16``: VGG-16's 16 layers, one segment, ``(N, 1)`` precision
  columns (the main path's chunk shape);
* ``mixed``: the same with ``(N, 16)`` act_bits / weight_bits /
  mac_energy_pj drawn from the four PE types
  (``numpy.random.default_rng(20220516)``);
* ``w3``: VGG-16 + ResNet-34 + ResNet-50 concatenated, 107 layers in
  three segments;

it prints one JSON line per shape:

* ``profiler_ms``: the kernel's device time per launch from
  ``torch.profiler`` (the smallest of three windows of back-to-back
  launches; a window that kept no record reads None);
* ``event_ms``: CUDA-event time per launch over back-to-back launches of
  the kernel alone (the layer table built once);
* ``wrapper_ms``: CUDA-event time per call of
  ``sweep_aggregates_packed`` back to back (checks, table, output
  allocation and launch: bound by the host when it is longer than the
  kernel);
* ``grid``: the grid the C entry reported (blocks, threads a block,
  shared-memory bytes a block) where the checkout's entry reports it,
  else the grid its source launches, ``ceil(N / 256) x W`` blocks of 256;
* ``sha256``: of the output's bytes; equal digests of two checkouts are
  the witness that their kernels agree bit for bit;
* ``max_rel_vs_plain``: against the plain version on the card.

With ``--stream`` it times the main path's stream instead: the
1,029,600-config VGG-16 grid in 32768-config chunks through
``repro_torch.core.dse.run`` (as ``chip_smoke.py``'s main path), and
prints its wall time, configs/s, host synthesis and kernel-wait times,
the kernel's launches, and the kernel's profiled device time over the
stream with its share of the wall time.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import pathlib
import sys
import time

N = 32768
GLB_KBS = tuple(2 ** i for i in range(2, 13))
KERNEL = "sweep_aggregates"


def _inputs(shape: str):
    import numpy as np
    from repro_torch.core.accelerator import design_space_soa
    from repro_torch.core.dse_batch import _make_cfg_lay, _workload_batch
    from repro_torch.core.pe import PEType, pe_spec
    from repro_torch.core.synthesis import synthesize_soa
    from repro_torch.core.workloads import get_workload
    soa = next(iter(design_space_soa(
        chunk_size=N, glb_kbs=GLB_KBS,
        bws=tuple(np.linspace(2.0, 64.0, 156)))))
    names = ("vgg16", "resnet34", "resnet50") if shape == "w3" \
        else ("vgg16",)
    wbs = [_workload_batch(get_workload(w)) for w in names]
    cfg, _ = _make_cfg_lay(soa, synthesize_soa(soa), wbs[0])
    lay = {k: np.concatenate([w.arrays[k] for w in wbs])[None, :]
           for k in wbs[0].arrays}
    bounds, s = [], 0
    for w in wbs:
        bounds.append((s, s + len(w)))
        s += len(w)
    if shape == "mixed":
        specs = [pe_spec(t) for t in PEType]
        a = np.random.default_rng(20220516).integers(
            0, len(specs), size=(N, s))
        cfg = dict(cfg,
                   act_bits=np.array([p.act_bits for p in specs])[a],
                   weight_bits=np.array([p.weight_bits for p in specs])[a],
                   mac_energy_pj=np.array([p.mac_energy_pj
                                           for p in specs])[a])
    return cfg, lay, tuple(bounds)


def _profiled_ms(fn, iters: int):
    """The kernel's device time per launch over ``iters`` launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        if KERNEL in ev.key and ev.count:
            us = getattr(ev, "self_device_time_total", 0.0)
            return us / ev.count / 1e3 if us else None
    return None


def _event_ms(fn, iters: int) -> float:
    import torch
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _raw_launch(K, dcfg, hlay, bounds, device):
    """A function that launches the checkout's kernel alone (its layer
    table built once), and the grid it launches."""
    import torch
    from repro_torch.kernels import _build
    lib = _build.library("sweep_kernel")
    n, l, w = N, int(hlay["r"].shape[1]), len(bounds)
    table = torch.from_numpy(K._layer_table(hlay, bounds)).to(device)
    out = torch.empty((n, 6 * w), dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    wide = [int(dcfg[k].shape[1] != 1) for k in K.MIXED_CFG_FIELDS]
    ptrs = [ctypes.c_void_p(dcfg[k].data_ptr())
            for k in K.KERNEL_CFG_FIELDS]
    ptrs += [ctypes.c_void_p(table.data_ptr()),
             ctypes.c_void_p(out.data_ptr())]
    if hasattr(K, "plan"):
        p = K.plan(n, bounds)
        info = (ctypes.c_int * 3)()
        args = ptrs + [n, l, w, p.blocks, p.smem, *wide, info,
                       ctypes.c_void_p(stream)]
        grid = None
    else:
        info = None
        args = ptrs + [n, l, w, max(e - s for s, e in bounds), *wide,
                       ctypes.c_void_p(stream)]
        grid = [-(-n // 256) * w, 256, "source"]

    def launch():
        err = lib.qappa_sweep_aggregates(*args)
        if err != 0:
            raise RuntimeError(f"launch failed: CUDA error {err}")
    launch()
    torch.cuda.synchronize()
    return launch, (list(info) if info is not None else grid), (table, out)


def _shape(shape: str, tag: str, src: str, iters: int) -> None:
    import numpy as np
    import torch
    from repro_torch.core.dse_batch import (AGGREGATE_OUTPUTS,
                                            _cfg_to_device, _lay_to_device)
    from repro_torch.kernels import sweep_kernel as K
    device = torch.device("cuda", 0)
    cfg, lay, bounds = _inputs(shape)
    dcfg = _cfg_to_device(cfg, device, exact=False)
    hlay = _lay_to_device(lay, torch.device("cpu"), exact=False)
    dlay = _lay_to_device(lay, device, exact=False)
    got = K.sweep_aggregates_packed(dcfg, hlay, bounds=bounds)
    torch.cuda.synchronize()
    digest = hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()
    ref = K.sweep_aggregates_ref(dcfg, dlay, bounds=bounds)
    plain = np.concatenate([ref[k].T.cpu().numpy()
                            for k in AGGREGATE_OUTPUTS], axis=1)
    g = got.cpu().numpy().astype(np.float64)
    rel = float(np.max(np.abs(g - plain)
                       / np.maximum(np.abs(plain), 1e-30)))
    launch, grid, keep = _raw_launch(K, dcfg, hlay, bounds, device)
    windows = [_profiled_ms(launch, iters) for _ in range(3)]
    kept = [w for w in windows if w is not None]
    row = {"tag": tag, "src": src, "shape": shape, "n": N,
           "l": int(hlay["r"].shape[1]), "w": len(bounds),
           "profiler_ms": min(kept) if kept else None,
           "profiler_windows": windows,
           "event_ms": _event_ms(launch, iters),
           "wrapper_ms": _event_ms(
               lambda: K.sweep_aggregates_packed(dcfg, hlay, bounds=bounds),
               iters),
           "grid": grid if grid is not None
           else list(getattr(K, "last_grid", None) or ()),
           "sha256": digest, "max_rel_vs_plain": rel,
           "max_abs_vs_plain": float(np.max(np.abs(g - plain)))}
    print(json.dumps(row), flush=True)
    del keep


def _stream(tag: str, src: str) -> None:
    import numpy as np
    import torch
    from repro_torch.core.accelerator import design_space_soa
    from repro_torch.core.dse import ExploreSpec, run
    from repro_torch.kernels import sweep_kernel as K
    device = torch.device("cuda", 0)

    def feed():
        return design_space_soa(chunk_size=N, glb_kbs=GLB_KBS,
                                bws=tuple(np.linspace(2.0, 64.0, 1560)))
    run(ExploreSpec.single("vgg16", feed(), chunk_size=N), device=device)
    K.launches = 0
    t0 = time.perf_counter()
    res = run(ExploreSpec.single("vgg16", feed(), chunk_size=N),
              device=device)
    wall = time.perf_counter() - t0
    launches = K.launches
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run(ExploreSpec.single("vgg16", feed(), chunk_size=N),
            device=device)
        torch.cuda.synchronize()
    kernel_ms = None
    for ev in prof.key_averages():
        if KERNEL in ev.key and ev.count:
            kernel_ms = getattr(ev, "self_device_time_total", 0.0) / 1e3
    print(json.dumps({
        "tag": tag, "src": src, "stream": True,
        "configs": res.n_configs, "chunks": res.n_chunks,
        "wall_s": wall, "configs_per_s": res.n_configs / wall,
        "timings": res.timings, "launches": launches,
        "kernel_device_ms_profiled_run": kernel_ms,
        "kernel_share_of_wall": (None if kernel_ms is None
                                 else kernel_ms / 1e3 / wall)}),
        flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(pathlib.Path(__file__).resolve()
                                         .parent.parent / "src"))
    ap.add_argument("--tag", default="")
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--stream", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import torch
    if not torch.cuda.is_available():
        print("time_sweep_kernel: CUDA is not available", file=sys.stderr)
        return 1
    if args.stream:
        _stream(args.tag, args.src)
        return 0
    for shape in ("vgg16", "mixed", "w3"):
        _shape(shape, args.tag, args.src, args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
