"""One-card dry run: count every (arch x shape) step and put it on the
Hopper roofline.

The port's counterpart of ``repro.launch.dryrun``, on one H100.  For each
cell the dry run:

  1. builds the params, optimizer state, caches and batch under
     ``FakeTensorMode`` at full width and depth (shapes without storage:
     nothing is allocated), as the reference builds ``ShapeDtypeStruct``
     stand-ins;
  2. runs the step under the op counter (``core.op_analysis``): every
     aten op with its real shapes, each kernel at the cost declared beside
     it (fake tensors take the kernels' plain versions for their output
     shapes);
  3. records the counts and the three-term roofline
     (``core.gpu_roofline``) in the reference's record schema under
     ``experiments/dryrun_torch/``, which ``benchmarks/roofline_bench.py``
     reads with ``DRYRUN_DIR=experiments/dryrun_torch``.

The steps are the reference's: train (``Model.loss``, its gradient, with
the reference's microbatch accumulation, and ``adamw.update``), prefill
(``forward(last_only=True)``) and decode (``decode_step`` at ``pos =
seq_len - 1``, so the whole cache is read).  The mesh is one card
(``"1"``): ``multi_pod`` and ``kv_seq_shard`` place work across cards
and are refused (ROADMAP A.11).

With ``measure=True`` (a card) the cell is also built for real from a
seeded generator and run on the card: the step counted again (the kernels
launch; the count must equal the dry run's), then timed by CUDA events
and by profiler device time (the largest of three windows); the record
gains ``measured_s``, ``measured_fraction`` (the roofline's step time over
it), the device-time counterparts, the peak allocated bytes and the
kernels' launches.

Usage (the host; add ``--measure`` on the card)::

  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch phi4-mini-3.8b \\
      --shape decode_4k --quant --kv-quant --measure
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig
from repro_torch.core.device import resolve_device
from repro_torch.core.gpu_roofline import H100, roofline_from_stats
from repro_torch.core.op_analysis import analyze_step, distinct_bases
from repro_torch.kernels import (flash_attention, w4a8_matmul, w8a8_decode,
                                 w8a8_matmul)
from repro_torch.models.model import Model
from repro_torch.models.tree import tree_map
from repro_torch.optim import adamw

OUT_DIR = "experiments/dryrun_torch"
#: shapes one card serves at full width (the reference's ``SHAPES`` are
#: sized for a pod): a decode step of batch 4 over a 4096-position cache
#: and a 1 x 4096 prefill
ONE_CARD_SHAPES = {
    "decode_4k": ShapeConfig("decode_4k", 4096, 4, "decode"),
    "prefill_4k": ShapeConfig("prefill_4k", 4096, 1, "prefill"),
}
#: the kernel modules whose launch counters a measured cell reads
KERNELS = {"w8a8_matmul": w8a8_matmul, "w4a8_matmul": w4a8_matmul,
           "w8a8_decode_attention": w8a8_decode,
           "flash_attention": flash_attention}
#: the seed of a cell's params and tokens (the chip_smoke.py draws')
SEED = 0
#: steps a measured cell is timed over by CUDA events, and steps in each
#: of the profiler's windows (reading back a window's trace of thousands
#: of device ops a step takes seconds)
MEASURE_ITERS = 5
PROFILE_ITERS = 1
MEASURE_WINDOWS = 3


def shape_config(name: str) -> ShapeConfig:
    """The reference's ``SHAPES[name]`` or one of :data:`ONE_CARD_SHAPES`."""
    if name in SHAPES:
        return SHAPES[name]
    if name in ONE_CARD_SHAPES:
        return ONE_CARD_SHAPES[name]
    raise KeyError(f"unknown shape {name!r}; the port has "
                   f"{list(SHAPES) + list(ONE_CARD_SHAPES)}")


def skip_reason(cfg: ArchConfig, shape: ShapeConfig) -> str | None:
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return ("full-attention arch: long_500k needs sub-quadratic "
                "attention (DESIGN.md §8)")
    return None


def input_specs(cfg: ArchConfig, shape: ShapeConfig, device,
                generator: torch.Generator | None = None) -> dict:
    """The step's inputs, in the active mode (fake tensors in the dry
    run): tokens (zeros, or drawn from ``generator``), labels for train,
    ``pos`` an int for decode, and the vlm / audio context away from
    decode."""
    b, s = shape.global_batch, shape.seq_len

    def tokens(n):
        if generator is None:
            return torch.zeros((b, n), dtype=torch.int32, device=device)
        return torch.randint(0, cfg.vocab, (b, n), generator=generator,
                             device=device, dtype=torch.int32)
    if shape.kind == "train":
        batch = {"tokens": tokens(s), "labels": tokens(s)}
    elif shape.kind == "prefill":
        batch = {"tokens": tokens(s)}
    else:
        batch = {"tokens": tokens(1), "pos": s - 1}
    if cfg.family in ("vlm", "audio") and shape.kind != "decode":
        batch["ctx"] = torch.zeros((b, cfg.n_ctx_tokens, cfg.d_model),
                                   dtype=torch.bfloat16, device=device)
    return {"batch": batch}


def _bf16_view(params):
    """Big float32 projection leaves cast to bf16 (the reference's
    ``_bf16_view``: compute in bf16, the float32 master kept)."""
    def cast(p):
        if p.dtype == torch.float32 and p.dim() >= 2 \
                and p.numel() >= (1 << 17):
            return p.to(torch.bfloat16)
        return p
    return tree_map(cast, params)


def build_cell(arch: str, shape_name: str, *, serve_quant: bool = False,
               kv_quant: bool = False, bf16_params: bool = False,
               weight_only_qat: bool = False, mode: str | None = None,
               microbatch: int = 1, device="cuda",
               params: dict | None = None):
    """Returns ``(step, args, model_flops)``: the cell's step, its
    arguments built in the active mode (params drawn from a generator
    seeded with :data:`SEED`, or ``params`` where given) and the
    reference's model FLOPs."""
    cfg = get_config(arch)
    if mode:   # override the exec mode (PE-type analogue), e.g. w4a8_pow2
        cfg = dataclasses.replace(cfg, quant=mode)
    shape = shape_config(shape_name)
    dev = resolve_device(device)
    model = Model(cfg, device=dev)
    if weight_only_qat:
        model.policy = dataclasses.replace(model.policy, qat_acts=False)
    gen = torch.Generator(dev).manual_seed(SEED)
    if params is None:
        params = model.init(gen, quantize=serve_quant
                            and shape.kind != "train")
    batch = input_specs(cfg, shape, dev, gen)["batch"]
    b, s = shape.global_batch, shape.seq_len
    tokens_total = b * (s if shape.kind != "decode" else 1)

    if shape.kind == "train":
        opt = adamw.init(params)
        ocfg = adamw.AdamWConfig()

        def train_step(params, opt, batch):
            leaves = tree_map(
                lambda p: p.detach().requires_grad_(True), params)
            p_view = _bf16_view(leaves) if bf16_params else leaves
            if microbatch > 1:
                # gradient accumulation over micro-slices: live activations
                # shrink by the microbatch factor
                loss = 0.0
                n = b // microbatch
                for i in range(microbatch):
                    mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                    part = model.loss(p_view, mb)
                    part.backward()
                    loss = loss + part.detach()
                loss = loss / microbatch
            else:
                loss = model.loss(p_view, batch)
                loss.backward()
            grads = tree_map(
                lambda p: p.grad / microbatch if p.grad is not None
                else torch.zeros_like(p), leaves)
            new_params, new_opt, _ = adamw.update(ocfg, grads, opt, leaves)
            return new_params, new_opt, loss.detach()

        args = (params, opt, batch)
        model_flops = 6.0 * cfg.n_active_params() * b * s
        return train_step, args, model_flops

    if shape.kind == "prefill":
        @torch.no_grad()
        def prefill_step(params, batch):
            logits, _ = model.forward(params, batch["tokens"],
                                      ctx=batch.get("ctx"), train=False,
                                      last_only=True)
            return logits

        return prefill_step, (params, batch), \
            2.0 * cfg.n_active_params() * tokens_total

    caches = model.init_cache(b, s, dtype=torch.bfloat16, kv_quant=kv_quant)

    @torch.no_grad()
    def serve_step(params, caches, batch):
        return model.decode_step(params, caches, batch["tokens"],
                                 batch["pos"])

    return serve_step, (params, caches, batch), \
        2.0 * cfg.n_active_params() * b


def _count(step, args) -> tuple:
    """``(result, StepStats, alias_bytes, seconds)`` of one counted run;
    ``alias_bytes``: result tensors that are arguments (updated caches)."""
    t0 = time.perf_counter()
    result, stats = analyze_step(step, *args)
    arg_ids = {id(t) for t in distinct_bases(args)}
    alias = sum(t.numel() * t.element_size() for t in distinct_bases(result)
                if id(t) in arg_ids)
    return result, stats, alias, time.perf_counter() - t0


def _launches() -> dict:
    return {name: mod.launches for name, mod in KERNELS.items()}


def _event_s(fn, iters: int) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters / 1e3


def _device_s(fn, iters: int) -> float | None:
    """Device time of one call from ``torch.profiler``: each kernel's mean
    over the records a window kept times its launches a call, summed;
    the largest of :data:`MEASURE_WINDOWS` windows (a window can drop
    records); None where no window has device time."""
    from torch.profiler import ProfilerActivity, profile
    best = None
    for _ in range(MEASURE_WINDOWS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = 0.0
        for ev in prof.key_averages():
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = getattr(ev, "self_cuda_time_total", 0.0)
            if us and ev.count:
                total += us / ev.count * math.ceil(ev.count / iters)
        if total:
            best = total / 1e6 if best is None else max(best, total / 1e6)
    return best


def _measure(step, args, roof, fake_stats) -> dict:
    """The cell on the card: counted (kernels launching), then timed."""
    torch.cuda.synchronize()
    before_alloc = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    launched = _launches()
    result, stats, _, count_s = _count(step, args)
    torch.cuda.synchronize()
    launches = {k: v - launched[k] for k, v in _launches().items()}
    peak = torch.cuda.max_memory_allocated()
    del result
    card = stats.as_dict()
    same = card == fake_stats.as_dict()

    def call():
        step(*args)
    t0 = time.perf_counter()
    measured = _event_s(call, MEASURE_ITERS)
    device = _device_s(call, PROFILE_ITERS)
    timing_s = time.perf_counter() - t0
    bound = roof.step_time_s
    return {"measured_s": measured,
            "measured_fraction": bound / measured,
            "device_s": device,
            "device_fraction": None if device is None else bound / device,
            "device_busy_share": None if device is None
            else device / measured,
            "peak_allocated_bytes": peak,
            "peak_temp_allocated_bytes": peak - before_alloc,
            "kernel_launches": launches,
            "card_count_s": count_s, "timing_s": timing_s,
            "card_stats": card,
            "card_count_equal": same,
            "card": torch.cuda.get_device_name(0)}


def _variant(kw: dict) -> str:
    """The record's suffix of a cell's options (the reference's tags)."""
    return "".join([
        "__quant" if kw["serve_quant"] else "",
        "__kvq" if kw["kv_quant"] else "",
        "__bf16p" if kw["bf16_params"] else "",
        "__woqat" if kw["weight_only_qat"] else "",
        f"__{kw['mode']}" if kw["mode"] else "",
        f"__mb{kw['microbatch']}" if kw["microbatch"] > 1 else "",
    ])


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             serve_quant: bool = False, kv_quant: bool = False,
             kv_seq_shard: bool = False, bf16_params: bool = False,
             weight_only_qat: bool = False, mode: str | None = None,
             microbatch: int = 1,
             out_dir: str | None = OUT_DIR, measure: bool = False,
             device=None, params: dict | None = None) -> dict:
    """Dry-run one cell (and with ``measure`` run it on the card); writes
    its record under ``out_dir`` (None: nowhere) and returns it.
    ``device``: the fake tensors' device, default the CPU (the card with
    ``measure``); CUDA raises on a host without it.  ``params``: the
    measured cell's params on the card, where several cells of one arch
    and mode share one draw (else drawn from :data:`SEED`)."""
    if multi_pod or kv_seq_shard:
        raise ValueError(
            "multi_pod and kv_seq_shard place work across cards: not on one "
            "card (ROADMAP A.11, placement across cards)")
    if measure and not torch.cuda.is_available():
        raise RuntimeError("run_cell(measure=True) times the step on a "
                           "card, and CUDA is not available")
    dev = resolve_device(device or ("cuda" if measure else "cpu"))
    cfg = get_config(arch)
    shape = shape_config(shape_name)
    mesh_name = "1"
    kw = dict(serve_quant=serve_quant, kv_quant=kv_quant,
              bf16_params=bf16_params, weight_only_qat=weight_only_qat,
              mode=mode, microbatch=microbatch)
    suffix = _variant(kw)
    tag = f"{arch}__{shape_name}__{mesh_name}{suffix}"
    reason = skip_reason(cfg, shape)
    if reason:
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
               "status": "skipped", "reason": reason}
        _dump(out_dir, tag, rec)
        return rec
    t0 = time.perf_counter()
    try:
        with FakeTensorMode():
            step, args, model_flops = build_cell(arch, shape_name,
                                                 device=dev, **kw)
            _, stats, alias, _ = _count(step, args)
            del step, args
        roof = roofline_from_stats(stats, arch=arch, shape=shape_name,
                                   mesh=mesh_name, chips=1,
                                   model_flops=model_flops)
        hbm = H100.hbm_gb * 1e9
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
               "status": "ok", "quant": serve_quant, "variant": suffix,
               "compile_s": round(time.perf_counter() - t0, 1),
               "memory_analysis": {
                   "argument_bytes": stats.argument_bytes,
                   "output_bytes": stats.output_bytes,
                   "temp_bytes": stats.temp_bytes,
                   "alias_bytes": alias,
                   "hbm_bytes": hbm,
                   "fits_hbm": stats.argument_bytes + stats.temp_bytes
                   <= hbm},
               "stats": stats.as_dict(),
               "roofline": roof.as_dict()}
    except Exception as e:  # a failure here is a bug in the system
        if measure:
            raise
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
               "status": "error", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-2000:]}
    if measure:
        step, args, _ = build_cell(arch, shape_name, device=dev,
                                   params=params, **kw)
        rec["measured"] = _measure(step, args, roof, stats)
        del step, args
        torch.cuda.empty_cache()
    _dump(out_dir, tag, rec)
    return rec


def _dump(out_dir, tag, rec):
    if out_dir is None:
        return
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, tag + ".json"), "w") as f:
        json.dump(rec, f, indent=1, default=str)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    help=f"one of {list(SHAPES) + list(ONE_CARD_SHAPES)}")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--quant", action="store_true",
                    help="serve with quantized weights (decode/prefill)")
    ap.add_argument("--kv-quant", action="store_true",
                    help="int8 KV cache with per-(pos,head) scales")
    ap.add_argument("--bf16-params", action="store_true",
                    help="bf16 param view inside loss (f32 master)")
    ap.add_argument("--weight-only-qat", action="store_true",
                    help="QAT on weights only (no act fake-quant)")
    ap.add_argument("--mode", default=None,
                    help="override exec mode: fp32|bf16|w8a8|w4a8_pow2")
    ap.add_argument("--microbatch", type=int, default=1,
                    help="gradient-accumulation microbatches (train)")
    ap.add_argument("--measure", action="store_true",
                    help="also build the cell for real and time it on the "
                         "card")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)

    archs = ALL_ARCHS if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    for arch in archs:
        for shape in shapes:
            rec = run_cell(arch, shape, serve_quant=args.quant,
                           kv_quant=args.kv_quant,
                           bf16_params=args.bf16_params,
                           weight_only_qat=args.weight_only_qat,
                           mode=args.mode, microbatch=args.microbatch,
                           measure=args.measure, out_dir=args.out)
            status = rec["status"]
            extra = ""
            if status == "ok":
                r, mem = rec["roofline"], rec["memory_analysis"]
                gb = (mem["argument_bytes"] + mem["temp_bytes"]) / 1e9
                extra = (f" bottleneck={r['bottleneck']}"
                         f" frac={r['roofline_fraction']:.3f}"
                         f" step={r['step_time_s']:.4g}s"
                         f" arg+temp={gb:.4g}GB"
                         f" fits={mem['fits_hbm']}"
                         f" count={rec['compile_s']}s")
                if "measured" in rec:
                    m = rec["measured"]
                    extra += (f" measured={m['measured_s']:.4g}s"
                              f" measured_fraction="
                              f"{m['measured_fraction']:.4g}")
            elif status == "error":
                extra = " " + rec["error"][:120]
            print(f"[{rec['mesh']}] {arch} x {shape}: {status}{extra}",
                  flush=True)


if __name__ == "__main__":
    main()
