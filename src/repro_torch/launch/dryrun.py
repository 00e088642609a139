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
(``"1"``).

``multi_pod`` (the 2 x 16 x 16 mesh ``"2x16x16"``, else 16 x 16
``"16x16"``) and ``kv_seq_shard`` count the cell's **sharded step** on
the reference's pod meshes, as one card of the mesh runs it
(:func:`run_pod_cell`).  The mesh is a real ``DeviceMesh`` over a
``fake`` process group of 256 / 512 ranks
(:func:`repro_torch.launch.mesh.fake_production_mesh`; this process is
rank 0, collectives move nothing).  The step's arguments, built under
``FakeTensorMode`` at full width and depth, become ``DTensor``s by the
rule tables (:func:`place_cell`: params and optimizer state by
:func:`~repro_torch.parallel.sharding.tree_pspecs`, the batch and caches
by :func:`batch_pspecs` / :func:`cache_pspecs`), the activations follow
``activation_sharding``'s ``shard()`` points, and the kernels and
plain products run on local shards (``kernels/ops.on_local_shards``,
``local_map``).  Every move of a placement is the port's choice, not
one of DTensor's strategies, so the collectives do not change with the
torch version.  The op counter sees one card's local ops and the
collectives the moves issue, at their operand bytes; the record has the
reference's schema
with ``chips`` = the mesh's size (never a one-card count divided by the
chips).  Under ``kv_seq_shard`` the decode body gathers the cache's
sequence whole over "model" on each card (the record's ``notes``).
:func:`run_pod_cell` with ``count=False`` records each card's argument
bytes alone (status ``"placed"``).

With ``measure=True`` (a card) the cell is also built for real from a
seeded generator and run on the card: the step counted again (the kernels
launch; the count must equal the dry run's), then timed by CUDA events
and by profiler device time (the largest of three windows); the record
gains ``measured_s``, ``measured_fraction`` (the roofline's step time over
it), the device-time counterparts, the peak allocated bytes and the
kernels' launches.

Usage (the host; add ``--measure`` on the card; ``--mesh pod``,
``multipod`` or ``both`` places the cells on the pod meshes instead)::

  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch phi4-mini-3.8b \\
      --shape decode_4k --quant --kv-quant --measure
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch deepseek-67b \\
      --shape train_4k --mesh both
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
from repro_torch.kernels import (flash_attention, ops, w4a8_matmul,
                                 w8a8_decode, w8a8_matmul)
from repro_torch.launch.mesh import (fake_production_mesh,
                                     make_production_mesh, mesh_sizes)
from repro_torch.models.model import Model
from repro_torch.models.tree import tree_map
from repro_torch.optim import adamw
from repro_torch.parallel.sharding import (P, activation_sharding,
                                           data_axes,
                                           default_activation_rules,
                                           leaf_specs, local_shape, place,
                                           tree_shardings)

OUT_DIR = "experiments/dryrun_torch"
#: where ``main`` writes the pod meshes' records (apart from the one-card
#: records, which ``benchmarks/roofline_bench.py`` reads)
POD_OUT_DIR = "experiments/dryrun_torch_pod"
#: what a record under ``kv_seq_shard`` counts for the decode attention
KV_SEQ_SHARD_NOTE = (
    "kv_seq_shard: the cache's sequence is split over 'model' in memory; "
    "each card writes its token into its own part, and the int8 decode "
    "body (or the bf16 einsum) gathers the sequence whole over 'model' "
    "before attending (counted all-gathers), no cross-rank merge of "
    "split-S partials")
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


def _fit(shape, spec, mesh) -> P:
    """Drop spec axes whose dim is not divisible by the mesh axis size."""
    sizes = mesh_sizes(mesh)

    def ax_size(ax):
        if ax is None:
            return 1
        if isinstance(ax, (tuple, list)):
            n = 1
            for a in ax:
                n *= sizes.get(a, 1)
            return n
        return sizes.get(ax, 1)

    out = []
    for i, dim in enumerate(shape):
        ax = spec[i] if i < len(spec) else None
        out.append(ax if ax is not None and dim % ax_size(ax) == 0 else None)
    return P(*out)


def _axis_prod(mesh) -> int:
    sizes = mesh_sizes(mesh)
    return sizes.get("pod", 1) * sizes.get("data", 1)


def batch_pspecs(cfg, shape, mesh, batch) -> dict:
    """The batch's specs: tokens (and labels) over the data axes (only
    "data" when the batch does not divide over both, none when not even
    that), train's sequence over "model"; ``pos`` replicated."""
    db = data_axes(mesh)
    b = shape.global_batch
    if b % _axis_prod(mesh) != 0:
        db = ("data",) if b % mesh_sizes(mesh).get("data", 1) == 0 \
            else None
    out = {}
    for k, v in batch.items():
        if k == "pos":
            out[k] = P()
        elif k == "ctx":
            out[k] = _fit(v.shape, (db, None, None), mesh)
        else:
            out[k] = _fit(v.shape, (db, "model" if shape.kind == "train"
                                    else None), mesh)
    return out


def cache_pspecs(cfg, shape, mesh, caches, *, kv_seq_shard=False) -> dict:
    """KV caches: batch->data normally; seq->data for batch=1 long ctx;
    ``kv_seq_shard`` additionally shards the cache sequence dim over the
    "model" axis (sharded flash-decode)."""
    b = shape.global_batch
    batch1 = b < _axis_prod(mesh) and b == 1
    db = ("pod", "data") if "pod" in mesh.mesh_dim_names else "data"
    out = {}
    for k, v in caches.items():
        if k in ("k", "v", "shared_k", "shared_v", "ctx_k", "ctx_v"):
            if batch1:
                spec = (None, None, "data", None, None)
            elif kv_seq_shard:
                spec = (None, db, "model", None, None)
            else:
                spec = (None, db, None, None, None)
        elif k in ("k_local", "v_local"):   # ring buffers: batch only
            spec = (None, db, None, None, None) if not batch1 \
                else (None, None, None, None, None)
        elif k in ("k_local_scale", "v_local_scale"):
            spec = (None, db, None, None) if not batch1 \
                else (None, None, None, None)
        elif k in ("k_scale", "v_scale"):
            if batch1:
                spec = (None, None, "data", None)
            elif kv_seq_shard:
                spec = (None, db, "model", None)
            else:
                spec = (None, db, None, None)
        elif k == "state":
            spec = (None, None, "model", None, None) if batch1 \
                else (None, "data", "model", None, None)
        elif k == "conv":
            spec = (None, None, None, None) if batch1 \
                else (None, "data", None, None)
        else:
            spec = ()
        out[k] = _fit(v.shape, spec, mesh)
    return out


def _local_bytes(pairs, mesh) -> int:
    """One card's bytes of ``[(tensor, spec)]``: each tensor's local
    shard under its spec."""
    return sum(math.prod(local_shape(tuple(t.shape), spec, mesh))
               * t.element_size() for t, spec in pairs)


def placement(cfg, shape, mesh, args, *, kv_seq_shard=False) -> dict:
    """Each placed argument group's bytes on one card of ``mesh``:
    ``params`` (and train's ``opt``) by ``tree_pspecs``, ``batch`` by
    :func:`batch_pspecs`, decode's ``caches`` by :func:`cache_pspecs`;
    a host scalar (``pos``, the optimizer's step) holds no card bytes."""
    params, batch = args[0], args[-1]
    groups = {"params": leaf_specs(params, mesh)}
    if shape.kind == "train":
        groups["opt"] = leaf_specs(args[1], mesh)
    elif shape.kind == "decode":
        specs = cache_pspecs(cfg, shape, mesh, args[1],
                             kv_seq_shard=kv_seq_shard)
        groups["caches"] = [(v, specs[k]) for k, v in args[1].items()]
    specs = batch_pspecs(cfg, shape, mesh, batch)
    groups["batch"] = [(v, specs[k]) for k, v in batch.items()
                       if isinstance(v, torch.Tensor)]
    return {k: _local_bytes(v, mesh) for k, v in groups.items()}


def place_cell(cfg, shape, mesh, args, *, kv_seq_shard=False) -> tuple:
    """The cell's arguments as ``DTensor``s on ``mesh`` (a ``DeviceMesh``),
    each rank keeping its own block (no collective): params and train's
    optimizer state by ``tree_pspecs``, decode's caches by
    :func:`cache_pspecs`, the batch by :func:`batch_pspecs`; host scalars
    (``pos``, the optimizer's step) stay."""
    params, batch = args[0], args[-1]
    out = [tree_shardings(mesh, params)]
    if shape.kind == "train":
        out.append(tree_shardings(mesh, args[1]))
    elif shape.kind == "decode":
        specs = cache_pspecs(cfg, shape, mesh, args[1],
                             kv_seq_shard=kv_seq_shard)
        out.append({k: place(v, mesh, specs[k]) for k, v in args[1].items()})
    specs = batch_pspecs(cfg, shape, mesh, batch)
    out.append({k: place(v, mesh, specs[k]) if isinstance(v, torch.Tensor)
                else v for k, v in batch.items()})
    return tuple(out)


def sharded_step(step, mesh, shape):
    """``step`` on ``mesh``: the reference's activation rules
    (``default_activation_rules``: sequence-parallel residual in train,
    batch 1 on the long cells) at every ``shard()`` point, and plain
    tensors made inside the step (positions, masks, zeros) taken as
    replicated."""
    from torch.distributed.tensor.experimental import implicit_replication
    rules = default_activation_rules(mesh, seq_sharded=shape.kind == "train",
                                     batch_1=shape.global_batch == 1)

    def run(*args):
        with activation_sharding(mesh, rules), implicit_replication():
            return step(*args)
    return run


def count_sharded(arch: str, shape_name: str, mesh, *, device="cpu",
                  kv_seq_shard: bool = False, params: dict | None = None,
                  **kw) -> tuple:
    """Build the cell (in the active mode: fake tensors in the dry run),
    place it on ``mesh`` and count its sharded step on this rank; returns
    ``(result, StepStats, alias_bytes, model_flops, groups)``, the
    result's ``DTensor``s as the step left them and ``groups`` each
    argument group's bytes on one card by the rule tables
    (:func:`placement`)."""
    cfg = get_config(arch)
    if kw.get("mode"):
        cfg = dataclasses.replace(cfg, quant=kw["mode"])
    shape = shape_config(shape_name)
    step, args, model_flops = build_cell(arch, shape_name, device=device,
                                         params=params, **kw)
    groups = placement(cfg, shape, mesh, args, kv_seq_shard=kv_seq_shard)
    placed = place_cell(cfg, shape, mesh, args, kv_seq_shard=kv_seq_shard)
    del args
    result, stats, alias, _ = _count(sharded_step(step, mesh, shape), placed)
    return result, stats, alias, model_flops, groups


def _bf16_view(params):
    """Big float32 projection leaves cast to bf16 (the reference's
    ``_bf16_view``: compute in bf16, the float32 master kept)."""
    def cast(p):
        if p.dtype == torch.float32 and p.dim() >= 2 \
                and p.numel() >= (1 << 17):
            return p.to(torch.bfloat16)
        return p
    return tree_map(cast, params)


def accumulate_grads(model, params, batch: dict, microbatch: int = 1, *,
                     view=None):
    """The train cell's loss and gradients with the reference's
    microbatch accumulation: ``microbatch`` equal slices of the batch, one
    backward each, gradients summed and divided by ``microbatch`` (the
    loss is a per-token mean, so their mean is the full batch's
    gradient), live activations shrunk by the factor; on a mesh each
    gradient is placed as its param.  ``view`` maps the
    params before the loss (``_bf16_view``).  Returns ``(loss, grads,
    leaves)``, ``leaves`` the params the gradients belong to; a leaf the
    loss does not reach gets zeros."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    p_view = view(leaves) if view is not None else leaves
    if microbatch > 1:
        loss = 0.0
        n = batch["tokens"].shape[0] // microbatch
        for i in range(microbatch):
            mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
            part = model.loss(p_view, mb)
            part.backward()
            loss = loss + part.detach()
        loss = loss / microbatch
    else:
        loss = model.loss(p_view, batch)
        loss.backward()
    grads = tree_map(lambda p: _placed_as(p.grad, p) / microbatch
                     if p.grad is not None else torch.zeros_like(p), leaves)
    return loss.detach(), grads, leaves


def _placed_as(grad, p):
    """A ``DTensor`` gradient moved to its param's placements (the
    reduce-scatter or all-reduce of its ``Partial`` sums, and any other
    move, chosen here and not by the first op that reads it)."""
    if ops.sharded(grad) and list(grad.placements) != list(p.placements):
        return grad.redistribute(p.device_mesh, p.placements)
    return grad


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
            loss, grads, leaves = accumulate_grads(
                model, params, batch, microbatch,
                view=_bf16_view if bf16_params else None)
            new_params, new_opt, _ = adamw.update(ocfg, grads, opt, leaves)
            return new_params, new_opt, loss

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


def _variant(kw: dict, kv_seq_shard: bool = False) -> str:
    """The record's suffix of a cell's options (the reference's tags)."""
    return "".join([
        "__quant" if kw["serve_quant"] else "",
        "__kvq" if kw["kv_quant"] else "",
        "__kvshard" if kv_seq_shard else "",
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
    and mode share one draw (else drawn from :data:`SEED`).

    ``multi_pod`` or ``kv_seq_shard`` count the cell's sharded step on a
    pod mesh instead (:func:`run_pod_cell`)."""
    if multi_pod or kv_seq_shard:
        if measure:
            raise ValueError("a pod mesh's cell is counted, not measured: "
                             "measure=True times one card")
        kw = dict(serve_quant=serve_quant, kv_quant=kv_quant,
                  bf16_params=bf16_params, weight_only_qat=weight_only_qat,
                  mode=mode, microbatch=microbatch)
        return run_pod_cell(arch, shape_name, multi_pod=multi_pod,
                            kv_seq_shard=kv_seq_shard, out_dir=out_dir,
                            device=device, count=True, **kw)
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
        rec, roof = _record(arch, shape_name, mesh_name, 1, stats, alias,
                            model_flops, serve_quant, suffix, t0)
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


def _record(arch, shape_name, mesh_name, chips, stats, alias, model_flops,
            quant, suffix, t0) -> tuple:
    """The reference's record of a counted cell, and its roofline."""
    roof = roofline_from_stats(stats, arch=arch, shape=shape_name,
                               mesh=mesh_name, chips=chips,
                               model_flops=model_flops)
    hbm = H100.hbm_gb * 1e9
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "status": "ok", "quant": quant, "variant": suffix,
           "compile_s": round(time.perf_counter() - t0, 1),
           "memory_analysis": {
               "argument_bytes": stats.argument_bytes,
               "output_bytes": stats.output_bytes,
               "temp_bytes": stats.temp_bytes,
               "alias_bytes": alias,
               "hbm_bytes": hbm,
               "fits_hbm": stats.argument_bytes + stats.temp_bytes <= hbm},
           "stats": stats.as_dict(),
           "roofline": roof.as_dict()}
    return rec, roof


def run_pod_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
                 kv_seq_shard: bool = False, out_dir: str | None = OUT_DIR,
                 device=None, count: bool = False, **kw) -> dict:
    """One cell on the reference's pod mesh (16 x 16, or 2 x 16 x 16 with
    ``multi_pod``), built under ``FakeTensorMode`` at full width and depth
    (nothing allocated).  With ``count``, its sharded step counted on one
    card of a fake-group ``DeviceMesh`` (:func:`count_sharded`): the
    reference's record with ``chips`` = the mesh's size and ``torch``,
    the version that counted it.  Without, each
    card's argument bytes under the rule tables alone (status
    ``"placed"``).  ``kw``: the cell's options, as :func:`run_cell`
    takes them."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    mesh_name = "x".join(str(n) for n in mesh.shape)
    dev = resolve_device(device or "cpu")
    cfg = get_config(arch)
    shape = shape_config(shape_name)
    suffix = _variant(kw, kv_seq_shard)
    tag = f"{arch}__{shape_name}__{mesh_name}{suffix}"
    base = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    reason = skip_reason(cfg, shape)
    if reason:
        rec = {**base, "status": "skipped", "reason": reason}
        _dump(out_dir, tag, rec)
        return rec
    t0 = time.perf_counter()
    if count:
        try:
            with fake_production_mesh(multi_pod=multi_pod) as dmesh, \
                    FakeTensorMode():
                _, stats, alias, model_flops, groups = count_sharded(
                    arch, shape_name, dmesh, device=dev,
                    kv_seq_shard=kv_seq_shard, **kw)
            rec, _ = _record(arch, shape_name, mesh_name, mesh.size(),
                             stats, alias, model_flops, kw["serve_quant"],
                             suffix, t0)
            rec["chips"] = mesh.size()
            # the port chooses the collectives; DTensor's own copies
            # inside a move still differ between torch versions
            rec["torch"] = torch.__version__
            rec["memory_analysis"]["argument_bytes_by_group"] = groups
            if kv_seq_shard and shape.kind == "decode":
                rec["notes"] = KV_SEQ_SHARD_NOTE
        except Exception as e:  # a failure here is a bug in the system
            rec = {**base, "status": "error",
                   "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-2000:]}
        _dump(out_dir, tag, rec)
        return rec
    try:
        with FakeTensorMode():
            _, args, model_flops = build_cell(arch, shape_name, device=dev,
                                              **kw)
            groups = placement(cfg, shape, mesh, args,
                               kv_seq_shard=kv_seq_shard)
            del args
        arg = sum(groups.values())
        hbm = H100.hbm_gb * 1e9
        rec = {**base, "status": "placed", "chips": mesh.size(),
               "quant": kw["serve_quant"],
               "variant": _variant(kw, kv_seq_shard),
               "place_s": round(time.perf_counter() - t0, 1),
               "model_flops": model_flops,
               "memory_analysis": {
                   "argument_bytes": arg,
                   "argument_bytes_by_group": groups,
                   "hbm_bytes": hbm,
                   "fits_hbm": arg <= hbm}}
    except Exception as e:  # a failure here is a bug in the system
        rec = {**base, "status": "error", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-2000:]}
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
    ap.add_argument("--mesh", default="card",
                    choices=("card", "pod", "multipod", "both"),
                    help="one card, or the sharded step counted on one "
                         "card of the 16x16 pod, the 2x16x16 multi-pod or "
                         "both")
    ap.add_argument("--kv-seq-shard", action="store_true",
                    help="shard the KV cache's sequence over 'model' "
                         "(pod meshes)")
    ap.add_argument("--out", default=None,
                    help=f"default {OUT_DIR} (card), {POD_OUT_DIR} (pods)")
    args = ap.parse_args(argv)
    pods = {"card": (), "pod": (False,), "multipod": (True,),
            "both": (False, True)}[args.mesh]

    archs = ALL_ARCHS if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    kw = dict(serve_quant=args.quant, kv_quant=args.kv_quant,
              bf16_params=args.bf16_params,
              weight_only_qat=args.weight_only_qat, mode=args.mode,
              microbatch=args.microbatch)
    for arch in archs:
        for shape in shapes:
            for multi_pod in pods:
                rec = run_pod_cell(arch, shape, multi_pod=multi_pod,
                                   kv_seq_shard=args.kv_seq_shard,
                                   out_dir=args.out or POD_OUT_DIR,
                                   count=True, **kw)
                _print(rec)
            if pods:
                continue
            rec = run_cell(arch, shape, measure=args.measure,
                           out_dir=args.out or OUT_DIR, **kw)
            _print(rec)


def _print(rec: dict) -> None:
    """One line of a record: its status, and a counted cell's bound."""
    status = rec["status"]
    extra = ""
    if status == "ok":
        r, mem = rec["roofline"], rec["memory_analysis"]
        gb = (mem["argument_bytes"] + mem["temp_bytes"]) / 1e9
        coll = rec["stats"]["collective_bytes"]
        extra = (f" bottleneck={r['bottleneck']}"
                 f" frac={r['roofline_fraction']:.3f}"
                 f" step={r['step_time_s']:.4g}s"
                 f" arg+temp={gb:.4g}GB"
                 f" fits={mem['fits_hbm']}"
                 + (f" coll={coll / 1e9:.4g}GB" if coll else "")
                 + f" count={rec['compile_s']}s")
        if "measured" in rec:
            m = rec["measured"]
            extra += (f" measured={m['measured_s']:.4g}s"
                      f" measured_fraction="
                      f"{m['measured_fraction']:.4g}")
    elif status == "error":
        extra = " " + rec["error"][:120]
    print(f"[{rec['mesh']}] {rec['arch']} x {rec['shape']}: {status}{extra}",
          flush=True)


if __name__ == "__main__":
    main()
