#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one NVIDIA GPU and check them: the
design-space sweep, the mixed-precision co-exploration search, the
serving-fleet simulator and the serving-objective searches, the scalar
dataflow oracle, the PPA models and RTL generator, the preemption-safe
runtime, quantized LM serving (dense, windowed dense, MoE, SSM, hybrid,
vision-language and audio), continuous batching over an int8 KV cache,
the full-sequence forward / prefill, the accuracy tiers 1 and 2 and QAT
training.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. build every CUDA kernel of the port from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, in parallel) and count the tensor-core
   instructions in each library's SASS (``cuobjdump``): bf16 ``wgmma``
   (HGMMA) must be in the bf16 flash library's, TF32 ``wgmma`` (HGMMA) or
   ``mma.sync`` (HMMA) in the float32 flash library's, int8 ``wgmma``
   (IGMMA) or ``mma.sync`` (IMMA) in W8A8's;
2. the sweep path, through ``repro_torch.core.dse.run``: the paper's
   720-point VGG-16 sweep (per-layer outputs, then aggregates through the
   sweep kernel) and a 1,029,600-config streamed sweep with a running
   Pareto front; the kernel's launch count is read around this phase;
3. sweep parity: the kernel against its plain PyTorch version on the card
   and against the exact float64 CPU path — every chunk of the
   102,960-config grid, a mixed-precision batch and the VGG-16 + ResNet-34
   + ResNet-50 concatenation — at <= 1e-6 relative, with identical
   streamed fronts;
3b. the many-workload and co-exploration paths, through
   ``repro_torch.core.dse.run``, each on the card and on the exact CPU
   path, the kernel's launch count read around each card run:
   ``explore_many`` (the uniform 720-point sweep of VGG-16, ResNet-34 and
   ResNet-50: headline ratios within 1e-6 of the exact path);
   ``coexplore`` (``ExploreSpec.mixed("vgg16", preset="default")``: nsga2,
   2048 evaluations, population 64) and ``coexplore_many`` (the three
   workloads, ``precision="mixed"``, preset ``many-default``): one kernel
   launch per evaluation chunk, wall time and the Evaluator's counters
   of both runs, every front row of the card's run re-scored on the
   exact path within 1e-6 (column by column within the plain version's
   own distance plus 1e-6, ROADMAP C.1), ``accuracy_noise`` identical,
   and whether the two fronts are identical (else the first evaluation
   at which the runs part); ``coexplore_golden`` (the setting of
   ``tests/golden_coexplore_many.json``): front genomes identical to the
   golden's on the card and on the CPU, objectives within 1e-9 of it on
   the CPU and 1e-6 on the card (float32 aggregates);
3b'. the serving-fleet simulator (``csrc/fleet_sim.cu``): ``fleet_parity``
   runs the fleet kernel on the latency / energy aggregates of the main
   path's first 32768-config chunk under the steady, bursty and
   interactive traces at 1, 8 and 17 slots (17: above the slots it keeps
   in registers) and in a 60-iteration window that cuts each trace:
   stamps and every ``metrics()`` column equal to its plain version's on
   the card bit for bit, 256 seeded candidates equal to the event-driven
   scalar oracle's; ``fleet_timing`` at N = 32768 and N = 1,048,576 (the
   chunk tiled 32x), steady, 8 slots: the kernel's profiler time and the
   call's (with its (R, N) -> (N, R) transposes) profiler and event
   times, the plain version on the card, the CPU route, the byte and
   issue bounds and the stamps' copy to the host;
   ``coexplore_serving`` (``ExploreSpec.mixed("vgg16",
   preset="serving-default")``: nsga2, 2048 evaluations, population 64,
   the steady trace, 8 slots) as the searches above, with one fleet-kernel
   launch per evaluation chunk; its serving columns re-scored on the exact
   CPU path request by request: every arrival iteration that differs is a
   counted ceil flip (``ceil(arrival / step)`` within the float32 step's
   distance of an integer), rows without one within the aggregates' own
   distance + 1e-6; ``serving_front_shift`` (the reference bench's claim:
   for the three traces at budget 1024, population 48, the serving
   objectives' front differs from the EDP front on at least one trace, on
   the card; front sizes and evaluations/s on the card and the CPU);
   ``scalar_oracle`` (``ExploreSpec.single("vgg16", engine="scalar")`` on
   the CPU: the 720 points equal the exact batched path's bit for bit,
   the main path's card points within 1e-6, headline ratios identical);
3c. ``ppa``: the paper's Fig. 2 suite (polynomial ridge models, k-fold
   CV) fitted on the 720-point space per PE type on the card and on the
   CPU: the same (degree, lambda) for all 12 models, cv_rmse, r2, mape
   and predictions within 1e-9 of the CPU's, the reference test's bars
   (r2 > 0.97, mape < 0.10); fit time on both, ``predict_batch`` and the
   oracle in µs a design; ``rtl``: each PE type's Verilog and that of
   the main path's first front config, structural stats and a sha256;
   ``resume``: the main path's stream through ``resume_sweep`` with
   injected failures, a child process (this script with
   ``--resume-child DIR CACHE``) SIGKILLed after two snapshots and
   resumed here, and a watchdog deadline each chunk misses (a spin
   kernel queued ahead of it), each with front bytes, counts and cache
   hits/misses equal to an uninterrupted card run's and every
   re-dispatch a kernel launch; and the ``default`` search resumed
   through an injected failure, equal to ``coexplore``'s card run;
   ``telemetry``: the stream (three runs each way, interleaved) and the
   search with tracing on and off, identical results, the Chrome trace
   valid with the stage spans, the overhead, and in one
   ``torch.profiler`` window the ``sweep.kernel`` ranges that enclose a
   sweep-kernel launch;
4. sweep timing at N = 32768: VGG-16 (L = 16, the main path's chunk),
   the same with ``(N, 16)`` mixed-precision columns, and VGG-16 +
   ResNet-34 + ResNet-50 (L = 107, W = 3); and at the search's launch, 64
   genomes with mixed columns on VGG-16 and on the three workloads
   (``search_l16``, ``search_w3``); profiler device time and CUDA
   events, the grid the C entry reports (held to
   ``kernels/sweep_kernel.plan``), beside the kernel's bound on an H100
   (float32 operations unfused at 33.5 TFLOP/s, since the build passes
   ``-fmad=false``; 3.35 TB/s) and an issue bound from the SASS
   instructions of a cell (``cuobjdump``) over the card's 528 schedulers;
5. the serving path at phi4-mini-3.8b's full width (32 layers, d 3072,
   vocab 200064, random weights from a seed): ``serve(...,
   quantize=True, smoke=False)`` in W8A8, and the same loop
   (``launch.serve.generate``) in W4A8-pow2, 8 prompt + 8 generated
   tokens at batch 4; each matmul kernel must launch exactly
   16 steps x 32 layers x 7 projections = 3584 times in its own run and
   never in the other's, W8A8 all on its split-k ``dp4a`` regime;
6. serving parity: the same full-width params and prompts teacher-forced
   for 4 steps through the kernels and through their plain versions —
   logits within 1e-6 x max|logit| (0 expected), identical greedy tokens;
   one decode step profiled for its device-busy share;
7. matmul parity at the decode shapes and ragged shapes, and for W8A8 at
   the tensor-core regime's shapes (m = 4096 and 64 at the four
   projection shapes, ragged m 41 and 700), kernel vs plain version
   bit for bit (both sum exactly in int32; W4A8 on the grid its planner
   gives, as its C entry reports the launch), with ``torch._int_mm`` as a
   third witness of the W8A8 integer product;
8. matmul timing at the four m = 4 projection shapes: device time from
   ``torch.profiler`` and CUDA-event time over back-to-back calls of the
   kernels, their plain versions and ``torch._int_mm``, weights rotated
   through more than the 50 MB L2 cache, beside the byte bound at
   3.35 TB/s, W4A8's rows with the grid, splits and blocks of each shape
   as its C entry reports the launch; the kernels line takes the
   profiler's device time; and
   W8A8 at m = 4096 (kernel, plain version, ``torch._int_mm``) beside the
   bound of its int8 operations (``qmatmul_prefill_timing``); both W8A8
   regimes on a layer at m = 16-64 (``qmatmul_regimes``, where the
   threshold between them sits);
9. ``serve_batcher_int8kv``: ``ContinuousBatcher`` over phi4-mini-3.8b at
   full width in W8A8 with an int8 KV cache (4 slots, max_seq 4096), 8
   requests with prompts of 8-32 and 8-16 new tokens from
   ``numpy.random.default_rng(1)``: every request completes at
   ``submit_iter + P + G - 1``, decode attention is called 32 times per
   iteration that ran a step (three kernel launches a call, as its C
   entry reports them), flash attention never; ms per
   iteration, tok/s, cache bytes, peak memory, one profiled iteration's
   device-busy share;
10. ``serve_batcher_parity_int8kv``: the kernel and plain routes
    teacher-forced 4 steps at per-slot positions (0 among them): identical
    int8 caches, logits within 2e-2;
11. ``prefill``: ``Model.prefill`` at 4 x 16 and ``Model.forward(...,
    last_only=True)`` at 1 x 4096: 32 flash launches per forward, all on
    the bf16 tensor-core route, and the W8A8 projections on the tensor
    cores (the replayed decode steps on split-k), finite
    logits; at 1 x 4096 the flash kernel within 2e-2 of the plain route's
    attention on every layer's own q, k, v, and each output row within
    2^-6 of its own max|value| (the median |value| printed beside), and the kernel route with
    that attention swapped in equal to the plain route bit for bit (the
    routes' logits differ beyond 2e-2: the W8A8 network amplifies one-ulp
    attention differences, reported per layer); the forward's wall time
    and the flash and W8A8 kernels' shares of its device time;
11b. ``prefill_fp32``: the FP32 mode's forward (phi4-mini at full width,
    depth cut to 2 layers, 1 x 4096): every flash launch on the float32
    route, within 1e-5 of the plain attention on each layer;
11c. ``ssm_serve`` / ``hybrid_serve``: mamba2-130m (24 Mamba-2 layers, d
    768) and zamba2-1.2b (38 layers, d 2048, the shared attention + MLP
    block after every 6th) at full width in W8A8 through
    ``launch.serve.generate`` (random weights from seed 0), batch 4, 8 + 8 tokens: 48 and 118
    W8A8 launches a step (2 a layer, 7 an application of the shared
    block), all on the split-k regime, no other kernel; ms a step,
    tok/s, peak memory; the served 16 tokens teacher-forced through the
    kernel and plain routes: logits and ``state``, ``conv``,
    ``shared_k``, ``shared_v`` identical after every step; one profiled
    step's busy share;
11d. ``ssm_prefill``: each model's 1 x 4096 forward: every projection on
    the tensor cores, 6 bf16 flash launches for zamba2; wall time, peak
    memory above the params, the device time split (W8A8 ``tc``, flash,
    the rest: the SSD and the other eager ops) and one layer's SSD alone;
    mamba2's kernel route equal to the plain route bit for bit, zamba2's
    flash within 2e-2 of the plain attention on each application's own
    q, k, v (and each row within 2^-6 of its own max) and, with that
    attention swapped in, equal to the plain route bit for bit;
    ``ssm_tc_shapes``: W8A8 ``tc`` at their projection
    shapes (mamba2's in_proj at the unaligned n = 3352 beside n = 3360),
    kernel equal to plain, beside ``torch._int_mm`` and the bound;
11e. ``loss``: ``Model.loss`` of mamba2-130m at full width under fp32 on
    ``SyntheticLM`` batch 0 (4 x 512), the same params on the card and
    the CPU, within 1e-5 relative;
11f. the windowed dense family, gemma3-4b at full width (34 layers, d
    2560, 8 heads x hd 256, 4 kv heads, vocab 262144, window 1024 on 29
    local layers, a global layer every 6th), W8A8, random weights from
    seed 0: ``window_serve`` (as ``ssm_serve``, bf16 KV: 238 W8A8
    launches a step, all split-k; logits and ``k``, ``v``, ``k_local``,
    ``v_local`` bit for bit between the routes over the served 32
    tokens);
    ``window_batcher`` (phase 9's batcher on gemma3: the decode kernel on
    rings of 1024 and global caches of 4096 at per-slot positions);
    ``window_ring`` (one local layer, b 4, int8 rings of 1024, per-slot
    starts 0, 5, 11, 23, stepped until every slot is at position 1100:
    the kernel route within 1e-5 x max|out| of the plain route, the ring
    within the same bound of a full cache of 2048 read through the slice
    branch, the bf16 ring within 2e-2 and 2^-6 a row of its slice, equal
    before the first wrap; the decode kernel's time at (4, 4, 2, 256) for
    S 1024 and 4096); ``window_prefill`` (the 1 x 4096 forward: 34 flash
    launches, 29 with window 1024, 238 W8A8 ``tc``; flash held per
    layer as ``prefill`` holds phi4's, against the plain route's chunked
    attention; flash timed on a local and a global layer's own q, k, v
    beside SDPA); ``window_wrap`` (the depth cut to 6 layers, one period
    of the pattern, int8 KV, batch 2, decoded through position 1100 on
    the kernel route, then 8 steps on each route from copies of the
    caches: logits within 2e-2, caches bit for bit);
11g. the MoE family, moonshot-v1-16b-a3b at full width and depth (48
    layers, d 2048, 16 heads x hd 128, MHA, 64 experts, top-6, vocab
    163840), W8A8 with bf16 experts, random weights from seed 0, drawn
    once for three phases: ``moe_serve`` (as ``ssm_serve``, bf16 KV: 192
    W8A8 launches a step, all split-k, nothing else; logits and ``k``,
    ``v`` bit for bit between the routes over the served 16 tokens; the
    assignments dropped past an expert's capacity C = 1 a step, of b x 6
    x 48; the step's bytes, every expert's among them);
    ``moe_int8kv`` (the served stream teacher-forced on int8 KV through
    both routes: 48 decode-kernel calls a step at rep 1, logits within
    2e-2, caches identical; the decode kernel at (4, 16, 1, 128), S
    4096, held to its plain version and timed); ``moe_prefill`` (the 1 x
    4096 forward: 192 W8A8 ``tc`` and 48 flash launches; flash held per
    layer as ``prefill`` holds phi4's, the kernel route with the plain
    attention swapped in equal to the plain route bit for bit, logits
    and aux; the routing choices that differ between the unswapped
    routes; the device-time split: W8A8 ``tc``, flash, the MoE layers
    (one layer's ``moe_ffn`` alone times 48; of it the expert products
    alone, by CUDA events), the rest; flash
    at (1, 16, 4096, 128) beside SDPA; W8A8 on a moonshot layer's four
    projections at m = 4); ``moe_phi35`` (phi3.5-moe-42b-a6.6b at full
    width, depth cut to 8 layers: served and teacher-forced on int8 KV
    as moonshot, the decode kernel at rep 4 timed at (4, 8, 4, 128), S
    4096, and flash at (1, 32, 4096, 128));
11h. the vlm and audio families, W8A8, random weights from seed 0:
    llama-3.2-vision-90b at full width (d 8192, 64 heads x hd 128, 8 kv
    heads, a cross layer after every 5th of its dense layers, 1601 image
    tokens) with **its depth cut to 60 of 100 layers** (57.35 GB in int8;
    100 layers are 92.8 GB, past the card), then whisper-medium at full
    width and depth (24 encoder, 24 decoder, 24 cross layers, d 1024, 1500
    frames), each drawn once for two phases: ``vlm_serve`` /
    ``audio_serve`` (a context drawn as ``serve`` draws it,
    ``fill_ctx_caches`` timed with its launches (W8A8 ``tc`` at m = 4 x
    n_ctx, whisper's encoder with its flash), then ``generate`` on the
    filled caches: every W8A8 product of a step on the split-k regime and
    one bf16 flash launch a cross layer at sq = 1, nothing else; the
    served 16 tokens teacher-forced through the kernel route, the kernel
    route with the plain attention swapped in and the plain route:
    swapped = plain bit for bit (context caches, logits, every cache),
    flash within 2e-2 x (1 + |out|) of the plain attention on every
    element of every application (the CPU tests' bf16 bound: the
    attention outputs pass 4, where a bf16 ulp is 2^-5) and 2^-6 a row,
    the unswapped
    logits' distance reported (C.3); ms a step, tok/s, busy share, device
    ops, weight and cache bytes; flash at the decode's cross shape and
    W8A8 at ``context_kv``'s shape timed beside their bounds, SDPA and
    ``torch._int_mm``); ``vlm_prefill`` / ``audio_prefill`` (the 1 x 4096
    and 4 x 448 forwards with a context: every projection on the tensor
    cores, flash for each self, encoder and cross application, the vlm's
    cross layers on the float32 route (its forward's context goes to
    ``context_kv`` uncast, as the reference's does); flash per
    application and the swapped route bit for bit as in the serve
    phases; wall times and the device time split: W8A8 ``tc`` and flash
    by kernel name, each kind of flash application timed alone times
    its count, the rest);
12. ``attention_parity``: both attention kernels against their plain
    versions (decode: bit for bit, at positions on the boundaries of its
    splits of S, within the 1e-5 x max|out| bound; flash: 1e-5 f32,
    2e-2 bf16), with ``scaled_dot_product_attention`` as a reported third
    witness;
13. ``attention_timing``: decode attention at S = 4096 and 32768 (every
    key live, inputs rotated past L2; the grid and the launches per call
    its C entry reports, the grid held to the planner's and to at least
    one block an SM) and both flash routes at (1, 24, 4096, 128) causal, bf16 and
    float32, beside their plain versions, SDPA (for float32 also SDPA's
    kernel name and its error against the plain version) and their
    bounds (float32: 3xTF32 on the tensor cores, and the CUDA-core
    rate);
14. the accuracy tiers and training: ``calibrate`` (the tier-1 tables
    of mamba2-130m and phi4-mini-3.8b at full depth and reduced width on
    the card into an empty cache, a hit on the second call, the card's
    tables within 1e-9 relative of the CPU's); ``validate_elites`` (a
    ``calibrated-quick``-shaped ``measured:mamba2-130m`` search, budget 48,
    population 8, on the card and the CPU: the same front; its elites'
    losses on the card and the CPU within the bf16 loss bar; then
    phi4-mini's 32-layer validation, one flash launch a layer a loss);
    ``grad_guard`` (ROADMAP C.13: reduced phi4-mini under W8A8 QAT and
    fp32, no kernel launch under grad, every leaf's gradient card vs
    CPU, flash once a layer under ``no_grad``); ``train``
    (``launch.train.train`` of mamba2-130m at full width and depth, W8A8
    QAT, 8 x 64, 20 steps: the loss falls, no kernel launches; step time
    and device share, tok/s, peak memory; the first two losses against
    the CPU's; one QAT step of phi4-mini-3.8b at full width cut to 2
    layers, loss and global gradient norm card vs CPU); ``train_restart``
    (the same model and step with int8 gradient compression and a
    checkpoint every 3 steps, 6 steps clean and with failures injected at
    steps 3 and 4: every loss and the final checkpoint byte for byte,
    compression card vs CPU, the step-2 checkpoint stepped on both
    devices);
15. ``roofline``: the port's dry run and roofline of whole steps
    (``launch/dryrun.run_cell(..., measure=True)``) on phi4-mini-3.8b at
    full width and depth: W8A8 decode on a bf16 and an int8 KV cache and
    W4A8-pow2 decode (batch 4, a 4096-position cache read to pos 4095),
    and the W8A8 1 x 4096 prefill; each cell counted under fake tensors,
    then on the card with its kernels launching (the counts equal, each
    kernel call counted a launch), then timed beside its roofline step
    time (``measured_fraction``), the count's temp bytes beside the peak
    the card allocated;
16. ``mesh``: placement across ranks.  A one-rank NCCL mesh
    (``make_sweep_mesh()``): the 720-point sweep (points and aggregates),
    ``.many`` of the three workloads, the chunked stream over the
    102,960-config grid and a ``many-quick`` nsga2 search, each bit for
    bit the call without ``mesh`` (same genomes and front, ``mesh_shards``
    1), the group destroyed after; then 4 gloo ranks on the one card
    (this script's children, ``--mesh-child RANK DIR``; NCCL puts one
    rank on a card): each rank's slice of that grid at W = 3 through the
    sweep kernel, gathered bit for bit the one-launch result (and of the
    grid less one row, one row padded); ``moe_ffn_ep`` on a moonshot
    layer at full width (64 experts, 4 x 64 tokens) on (1, 4) and
    (2, 2) against ``moe_ffn`` on each data slice within 2e-2 x (1 +
    |want|) (the CPU tests' bf16 bar), aux within 1e-6; ``reshard`` of a
    train state (4, 1) -> (2, 2) -> ``survivable_mesh`` of 3 ranks, bit
    for bit, on host meshes (a DTensor of CUDA tensors over gloo
    crashes);
17. ``pod_count``: the sharded step under the op counter.  (i) phi4-mini
    at full width and depth (seed 0), W8A8 decode on an int8 KV cache
    (batch 4, 4096 positions) and the W8A8 1 x 4096 prefill, each run as
    a sharded step on a one-rank NCCL ``DeviceMesh`` (1, 1) with every
    argument a ``DTensor`` by the rule tables and the kernels on the
    local shards (``launch/dryrun.count_sharded``): logits and caches bit
    for bit the unsharded step's, each kernel's launches equal to the
    counter's calls of it, the card's count equal field for field to the
    fake group's at (1, 1) and to the one-card dry run's, no collective
    byte; (ii) this script's child (``--pod-child DIR``, started before
    the build, since a fake process group cannot share a process with the
    NCCL one) counts phi4-mini's pod cells on fake-group meshes (16 x 16
    ``decode_32k`` W8A8 + int8 KV, the same on 2 x 16 x 16 with the
    cache's sequence split, ``prefill_32k`` W8A8, ``train_4k``) and the
    phase prints each one's bottleneck, FLOPs a card by class, collective
    bytes a card by kind, step time and ``fits_hbm``, and holds the
    collectives to the ones pinned in ``POD_COUNT`` (the same under
    every torch version).

The model kernels' bounds (W8A8, W4A8, decode attention, flash) take
their work from each kernel's ``cost()`` (``kernels/*.py``); every bound
takes the card's peaks from ``repro_torch.core.gpu_roofline.H100``.

The sweep kernel's entry of the kernels line also gives its launches in
the three full-budget searches (``launches_coexplore``); the seventh
entry, ``fleet_sim``, is the kernel that replaces the reference's jitted
``fori_loop`` (not a Pallas kernel), its launches those of the
serving-default search.  The last lines
are a ``{"phase_seconds": [...]}`` line (each phase's wall seconds), the
total, a ``{"kernels": [...]}`` JSON line, the card's name and
power limit from ``nvidia-smi``, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import ctypes
import json
import math
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
# the card's peaks: the H100 SXM data sheet's, as the port's roofline
# keeps them (H100.peak("fp32_dot"): the float32 flash route's 3xTF32)
from repro_torch.core.gpu_roofline import H100  # noqa: E402
# float32 operations of the sweep function, counted from the reference's
# expressions: per (config, layer), and per (config, segment) outside the
# layers; the kernel builds with -fmad=false, so each issues unfused at
# half the 67 TFLOP/s FMA-counted rate
F32_OPS_PER_CELL = 51
F32_OPS_PER_CONFIG = 18
PEAK_F32_OPS_UNFUSED = H100.peak_fp32_flops / 2
# the sweep kernel's timing shapes: the main path's chunk (VGG-16, uniform
# columns), the same with (N, 16) mixed-precision columns, and the W = 3
# concatenation of the many-workload path
TIMING_SHAPES = ("vgg16", "mixed", "w3", "search_l16", "search_w3")
TIMING_W3 = ("vgg16", "resnet34", "resnet50")
# the co-exploration's launch shape: one nsga2 generation of genomes
SEARCH_N = 64
# the full-budget searches of the co-exploration phases (their presets'
# budgets: 2048 evaluations, population 64) and the golden setting of
# tests/golden_coexplore_many.json
COEXPLORE = dict(workload="vgg16", preset="default", seed=0)
COEXPLORE_MANY = dict(workloads=TIMING_W3, preset="many-default", seed=0)
GOLDEN = ROOT / "tests" / "golden_coexplore_many.json"
# the stages of a search whose cumulative host time the phases report:
# the whole engine, the Evaluator (sweep and objectives), the per-
# generation hypervolume of the archive, sorting and crowding, the
# archive's non-dominated reduction, crossover and mutation
SEARCH_STAGES = ("nsga2", "evaluate", "_sweep_mixed", "_sweep_mixed_many",
                 "hypervolume", "_ranks_and_crowding", "_front",
                 "crossover", "mutate", "simulate_fleet", "fleet_stamps",
                 "metrics")
GOLDEN_RTOL = 1e-9
# the serving-fleet simulator: the traces of the reference bench
# (benchmarks/serving_dse_bench.py), a serving window that cuts each, the
# scalar oracle's seeded sample, the timing shape (8 slots; the 1,048,576
# candidates are the chunk tiled 32x), the serving-default search and the
# front-shift campaigns (budget 1024, population 48, seed 0)
FLEET_TRACES = ("steady", "bursty", "interactive")
FLEET_CUT_ITERS = 60
FLEET_SAMPLE = 256
FLEET_SAMPLE_SEED = 20220516
FLEET_SLOTS_TIMED = 8
FLEET_TILE = 32
COEXPLORE_SERVING = dict(workload="vgg16", preset="serving-default", seed=0)
FRONT_SHIFT = dict(budget=1024, pop_size=48, seed=0)
SERVING_OBJS = ("p99_latency_s", "energy_per_token_j", "accuracy_noise")
EDP_OBJS = ("edp", "accuracy_noise")
# results of earlier phases that later phases compare with (the main
# path's stream, the card's searches)
KEEP: dict = {}

# the PPA models (paper Fig. 2) on the paper's 720-point space: the
# reference test's bars, and how far the card's fit may stray from the
# CPU's (float64 solve rounding)
PPA_R2_MIN = 0.97
PPA_MAPE_MAX = 0.10
PPA_RTOL = 1e-9
# the preemption-safe runtime on the main path's stream: snapshots every
# 4 chunks, injected failures at chunk boundaries 5 (once) and 17
# (twice), a real SIGKILL of a child once 2 snapshots exist, a watchdog
# deadline that fires on every chunk, and nsga2 failing once at
# generation 8 of the default search
RESUME_EVERY = 4
RESUME_FAIL_AT = {5: 1, 17: 2}
KILL_AFTER_SNAPSHOTS = 2
WATCHDOG_DEADLINE_S = 1e-6
# a chunk's results are back before the watchdog's first look (the host
# takes longer to stage and launch a chunk than the card to run it); a
# spin of this many SM cycles (~10 ms) queued ahead of each chunk on the
# card makes it late
WATCHDOG_SPIN_CYCLES = 20_000_000
SEARCH_FAIL_AT = {8: 1}
# the telemetry phase: interleaved stream runs with tracing on and off,
# and the stage spans the exported Chrome trace must carry
TELEMETRY_REPEATS = 3
TRACE_SPANS = ("sweep.pull", "sweep.synthesize", "sweep.dispatch",
               "sweep.kernel", "sweep.reduce", "nsga2.generation",
               "explore.evaluate")
CHILD_FLAG = "--resume-child"

# the serving path: phi4-mini-3.8b at full width
SERVE_ARCH = "phi4-mini-3.8b"
SERVE = dict(batch=4, prompt_len=8, gen=8, seed=0)
PARITY_STEPS = 4
# phi4-mini's projections per layer at m = batch: (k, n) -> count
LAYER_PROJ = {(3072, 3072): 2, (3072, 1024): 2, (3072, 8192): 2,
              (8192, 3072): 1}
RAGGED = ((1, 96, 40), (3, 130, 257), (17, 512, 1000), (128, 4096, 4096))
L2_BYTES = 50 * 2 ** 20

# continuous batching over the int8 KV cache, and the prefill shapes
BATCHER = dict(n_slots=4, max_seq=4096, n_requests=8, prompt=(8, 32),
               new=(8, 16), seed=1)
PARITY_OFFSETS = (0, 5, 11, 23)       # per-slot start positions
PREFILL = dict(batch=4, prompt_len=16, long_len=4096)
LOGIT_TOL = 2e-2                      # bf16 routes (tests/test_torch_serve)
DECODE_TOL = 1e-5                     # x max|out| (tests/test_kernels_decode)
FLASH_TOL = {"float32": 1e-5, "bfloat16": 2e-2}   # tests/test_kernels.py
# bf16 flash on a model's own q, k, v: besides FLASH_TOL, each output row
# (a query position and head) within 2^-6 of that row's own max|value|
# (an output element's bf16 ulp is at most 2^-7 of it)
FLASH_ROW_RTOL = 2.0 ** -6
# decode attention at phi4-mini's serving shape: (b, kvh, rep, hd)
DECODE_SHAPE = (4, 8, 3, 128)
DECODE_S = (4096, 32768)
# the split decode kernel's design: logits, exp and PV launches a call
DECODE_LAUNCHES_PER_CALL = 3
H100_SMS = 132
FLASH_SHAPE = (1, 24, 4096, 128)      # (b, h, s, d), causal, bf16
# the prefill shape of the W8A8 tensor-core regime: m = 1 x 4096 tokens
PREFILL_M = 4096
# m at which both W8A8 regimes are timed, around the threshold
REGIME_M = (16, 24, 32, 40, 48, 64)
# the FP32 PE mode's forward: phi4-mini at full width, depth cut to this
FP32_LAYERS = 2
# the SSM and hybrid families at full width and depth, served as phi4 is
# (SERVE) and forwarded at 1 x PREFILL["long_len"]; W8A8's tensor-core
# regime at their projection shapes (mamba2's in_proj 768 x 3352 beside
# an aligned 768 x 3360, its out_proj, zamba2's in_proj and out_proj)
SSM_ARCHS = {"ssm": "mamba2-130m", "hybrid": "zamba2-1.2b"}
SSM_TC_SHAPES = ((768, 3352), (768, 3360), (1536, 768), (2048, 8384),
                 (4096, 2048))
# the windowed dense family: gemma3-4b at full width (34 layers, 8 heads x
# hd 256, 4 kv heads, window 1024, a global layer every 6th), W8A8 as
# configured, served as phi4 is (SERVE, BATCHER) and forwarded at
# 1 x PREFILL["long_len"]
WINDOW_ARCH = "gemma3-4b"
# window_ring: one local layer, a slot per PARITY_OFFSETS, stepped until
# every slot's position reaches RING["until"] (past the 1024 of its
# ring), against a full cache of RING["full_s"] through the slice branch
RING = dict(until=1100, full_s=2048)
# window_wrap: the depth cut to one period of the pattern (5 local, 1
# global), int8 KV, decoded on the kernel route through position "until",
# then "steps" more on both routes
WRAP = dict(n_layers=6, batch=2, until=1100, steps=8, max_seq=2048)
# the MoE family: moonshot-v1-16b-a3b at full width and depth (48 layers,
# d 2048, 16 heads x hd 128, MHA, 64 experts, top-6, vocab 163840), W8A8
# (its experts bf16), served as phi4 is (SERVE), teacher-forced on int8
# KV, forwarded at 1 x PREFILL["long_len"]; phi3.5-moe-42b-a6.6b at full
# width (d 4096, 32 heads, 8 kv heads, 16 experts, top-2, ff 6400) with
# its depth cut to MOE_PHI["n_layers"] (21 GB; 32 layers of bf16 experts
# are 80.5 GB, past the 80 GB card with the rest)
MOE_ARCH = "moonshot-v1-16b-a3b"
MOE_PHI = dict(arch="phi3.5-moe-42b-a6.6b", n_layers=8)
# the W8A8 products of a moonshot layer at decode: wq, wk, wv, wo
MOE_LAYER_PROJ = {(2048, 2048): 4}
# the vlm and audio families, W8A8: llama-3.2-vision-90b at full width
# (d 8192, 64 heads x hd 128, 8 kv heads, ff 28672, vocab 128256, 1601
# image tokens) with its depth cut to 60 of 100 layers (12 groups of 5
# and 12 cross layers: 57.35 GB in int8; all 100 are 92.8 GB, past the
# 80 GB card), and whisper-medium at full width and depth (24 encoder,
# 24 decoder and 24 cross layers, d 1024, 16 heads x hd 64, 1500
# frames); served as phi4 is (SERVE) and forwarded at 1 x 4096 (the vlm)
# and 4 x 448 (Whisper's 30 s window and 448-token decoder limit)
# what a decode step of theirs reads: every decoder projection and a cross
# layer's wq_x and wo_x (wk_img, wv_img made the context caches)
PROJ_NAMES_DECODE = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                     "wq_x", "wo_x")
CROSS_ARCHS = {"vlm": dict(arch="llama-3.2-vision-90b", n_layers=60,
                           full_layers=100, forward=(1, 4096)),
               "audio": dict(arch="whisper-medium", n_layers=None,
                             full_layers=24, forward=(4, 448))}
# the evaluation loss: mamba2-130m under fp32 on SyntheticLM batch 0,
# card vs CPU
LOSS = dict(arch="mamba2-130m", quant="fp32", batch=4, seq_len=512, step=0,
            rtol=1e-5)
# accuracy tiers 1 and 2 and training: the tier-1 tables (card vs CPU),
# the tier-2 validation of a calibrated-quick-shaped search, the grad rule
# on reduced phi4-mini, QAT training at full width
CALIBRATE = dict(archs=("mamba2-130m", "phi4-mini-3.8b"), rtol=1e-9)
VALIDATE = dict(workload="vgg16", preset="calibrated-quick",
                model="mamba2-130m", attention_model="phi4-mini-3.8b",
                budget=48, pop_size=8, max_elites=4, loss_rtol=2.5e-4)
# per-leaf gradient bars, card vs CPU, each leaf to its largest magnitude:
# set from the card's readings on an H100 80GB HBM3 at 700 W (the worst
# leaf 5.6e-4 under W8A8 QAT, in bf16; 8.4e-7 under fp32), about 10x above
GRAD_GUARD = dict(arch="phi4-mini-3.8b", batch=2, seq_len=16,
                  bars={"w8a8": 5e-3, "fp32": 1e-5})
# card vs CPU at full width under W8A8 QAT (bf16): losses at the later
# steps' bar of tests/test_torch_train.py (at d 768 the bf16 activation
# scales part the first step's losses by 4.0e-4, past the reduced
# models' 2.5e-4); the global gradient norm at 2e-3, set from the card's
# reading on the same H100 (4.4e-4 for phi4-mini at 2 layers)
TRAIN = dict(arch="mamba2-130m", steps=20, batch=8, seq_len=64, timed=3,
             attention_arch="phi4-mini-3.8b", attention_layers=2,
             attention_batch=2, loss_rtol=1e-3, norm_rtol=2e-3)
# the restarting train loop at full width: mamba2-130m under W8A8 QAT with
# int8 gradient compression, a checkpoint every 3 steps, the clean run
# against one with two injected failures (bit for bit); compression card
# vs CPU bit for bit; the clean run's step-2 checkpoint continued one step
# on the card and on the CPU (the train phase's loss bar); step time with
# and without compression in turns
TRAIN_RESTART = dict(arch="mamba2-130m", steps=6, batch=8, seq_len=64,
                     ckpt_every=3, fail_at={3: 1, 4: 1}, elastic_step=2,
                     timed=2, loss_rtol=1e-3)
# steps in a whole step's profiler window (busy share, device ops): cut
# from 3, since reading back the trace of thousands of device ops a step
# takes seconds a step
BUSY_STEPS = 1
# the roofline phase (launch/dryrun.run_cell(measure=True)): phi4-mini at
# full width and depth, W8A8 decode on a bf16 and an int8 KV cache (batch
# 4, a 4096-position cache read up to pos 4095), the W8A8 1 x 4096
# prefill, then W4A8-pow2 decode; each kernel of the model path launches
# in one of them
ROOFLINE = dict(arch="phi4-mini-3.8b", cells=(
    ("decode_4k", dict(serve_quant=True)),
    ("decode_4k", dict(serve_quant=True, kv_quant=True)),
    ("prefill_4k", dict(serve_quant=True)),
    ("decode_4k", dict(serve_quant=True, mode="w4a8_pow2"))))
# the mesh phase: 4 gloo ranks on the one card (NCCL takes one rank a
# card), the padded slice of (b)'s sweep one row past a multiple of 4,
# the EP input of moonshot (batch x seq tokens of d 2048) and the bf16
# bar of the CPU tests (2e-2 x (1 + |want|)), the children's time limit
MESH_CHILD_FLAG = "--mesh-child"
MESH = dict(world=4, pad=1, search=dict(preset="many-quick", seed=0),
            ep=dict(batch=4, seq=64, meshes=((1, 4), (2, 2)), tol=2e-2),
            reshard_arch="mamba2-130m", timeout_s=300)
# the pod_count phase: (i) phi4-mini's W8A8 decode on an int8 KV cache
# (batch 4, 4096 positions) and 1 x 4096 prefill as a sharded step on a
# one-rank NCCL DeviceMesh (1, 1), every argument a DTensor; (ii) this
# script's child (--pod-child DIR, started at the top of the run: a fake
# process group cannot share a process with the NCCL one) counting the
# pod cells (shape, options, multi_pod, kv_seq_shard) on the fake-group
# 16 x 16 and 2 x 16 x 16 meshes
POD_CHILD_FLAG = "--pod-child"
POD_COUNT = dict(
    arch="phi4-mini-3.8b",
    cells=(("decode_4k", dict(serve_quant=True, kv_quant=True)),
           ("prefill_4k", dict(serve_quant=True))),
    pods=(("decode_32k", dict(serve_quant=True, kv_quant=True), False,
           False),
          ("decode_32k", dict(serve_quant=True, kv_quant=True), True,
           True),
          ("prefill_32k", dict(serve_quant=True), False, False),
          ("train_4k", dict(), False, False)),
    # each pod cell's collective bytes and counts a card by kind, (shape,
    # mesh) -> (bytes, counts), as torch 2.13 counts them: the port
    # chooses every redistribution of these cells itself (products and
    # einsums on local shards, the decode's residual, a gathering
    # reshape, a Partial amax, a gradient placed as its param), so the
    # pod count must not move with the torch version
    collectives={
        ("decode_32k", "16x16"): (
            {"all-gather": 27200512, "all-reduce": 3195904},
            {"all-gather": 386, "all-reduce": 321}),
        ("decode_32k", "2x16x16"): (
            {"all-gather": 580766720, "all-reduce": 1599360},
            {"all-gather": 514, "all-reduce": 545}),
        ("prefill_32k", "16x16"): (
            {"all-gather": 2442955776, "all-reduce": 26172457984},
            {"all-gather": 418, "all-reduce": 321}),
        ("train_4k", "16x16"): (
            {"all-gather": 13299878912, "reduce-scatter": 91479097344,
             "all-reduce": 1870954},
            {"all-gather": 647, "reduce-scatter": 451, "all-reduce": 1062})},
    timeout_s=900)
# tensor-core instructions each redesigned library must hold: bf16 wgmma
# (HGMMA) for bf16 flash, TF32 wgmma (HGMMA) or mma.sync (HMMA) for
# float32 flash, int8 wgmma (IGMMA) or mma.sync (IMMA) for W8A8
SASS_OPS = ("HGMMA", "IGMMA", "IMMA", "HMMA")
TENSOR_CORE_SASS = {"flash_attention_tc": ("HGMMA",),
                    "flash_attention": ("HGMMA", "HMMA"),
                    "w8a8_matmul": ("IGMMA", "IMMA")}
# W8A8 only: the tensor-core regime at the prefill shapes (m = 4096 and the
# 4 x 16 prefill's m = 64) and ragged above its threshold
W8A8_TC = tuple((m, k, n) for m in (PREFILL_M, 64) for k, n in LAYER_PROJ) \
    + ((41, 258, 301), (700, 1030, 777))


#: (phase, wall seconds since the previous phase's row) in emit order
PHASE_SECONDS = []
_LAST_EMIT = [time.perf_counter()]


def emit(obj) -> None:
    """Print a result row; a phase's row also closes its wall time."""
    if "phase" in obj:
        now = time.perf_counter()
        PHASE_SECONDS.append([obj["phase"], now - _LAST_EMIT[0]])
        _LAST_EMIT[0] = now
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


def _bound(cost) -> dict:
    """The least time the card could take for a kernel call's work
    ``cost`` = (operations, bytes, class), as the kernel's ``cost()``
    counts it: the bytes over the memory rate or the operations over the
    class's peak (``repro_torch.core.gpu_roofline.H100``), the larger."""
    ops_, nbytes, cls = cost
    bytes_ms = nbytes / H100.hbm_bw * 1e3
    ops_ms = ops_ / H100.peak(cls) * 1e3
    return dict(bytes=nbytes, ops=ops_, bytes_ms=bytes_ms, ops_ms=ops_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def flash_row_err(got, want) -> dict:
    """bf16 flash ``got`` against the plain attention ``want`` (any
    layout with head_dim last): the largest absolute error, the largest
    error of a row over that row's own max|want|, and the median |want|
    that the absolute error compares with; ``scaled``, the largest error
    of an element over 1 + its own |want| (the CPU tests' bf16 bound
    ``rtol = atol = 2e-2`` holds where ``scaled`` <= 2e-2)."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    row = err.amax(-1) / w.abs().amax(-1).clamp_min(1e-30)
    return {"max_abs": float(err.max()), "row_rel": float(row.max()),
            "scaled": float((err / (1 + w.abs())).max()),
            "max_abs_want": float(w.abs().max()),
            "median_abs_want": float(w.abs().median())}


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip()


def _sass_counts(path) -> dict:
    """Tensor-core instructions in a library's SASS (``cuobjdump``)."""
    import re
    from repro_torch.kernels import _build
    tool = pathlib.Path(_build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "--dump-sass", str(path)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass)) for op in SASS_OPS}


def phase_build() -> dict:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    paths = _build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in _build.build_log(name).splitlines()
                    if "registers" in ln or "spill" in ln]
             for name in sorted(paths)}
    sass = {name: _sass_counts(path) for name, path in sorted(paths.items())}
    for name, ops in TENSOR_CORE_SASS.items():
        check(any(sass[name][op] > 0 for op in ops),
              f"{name}: no {' or '.join(ops)} in its SASS")
    return {"phase": "build", "build_s": build_s,
            "libraries": sorted(p.name for p in paths.values()),
            "ptxas": ptxas, "sass_tensor_core_instructions": sass}


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
    KEEP["stream"] = stream
    KEEP["points"] = points

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


def phase_explore_many(device) -> dict:
    """The uniform sweep of the workload suite on the paper's 720-point
    space, through run(ExploreSpec.many(...)): each workload's headline
    ratios against the same spec on the exact CPU path."""
    from repro_torch.core.dse import DSEPoint, DSEResult, ExploreSpec, run
    from repro_torch.kernels import sweep_kernel

    spec = ExploreSpec.many(TIMING_W3, outputs="aggregates")
    sweep_kernel.launches = 0
    t0 = time.perf_counter()
    card = run(spec, device=device)
    card_s = time.perf_counter() - t0
    launches = sweep_kernel.launches
    check(launches == len(TIMING_W3),
          f"explore_many: {launches} kernel launches, one per workload "
          f"expected")
    t0 = time.perf_counter()
    exact = run(spec, device="cpu")
    cpu_s = time.perf_counter() - t0

    def ratios(sweep):
        return DSEResult(sweep.workload, [
            DSEPoint(c, sweep.result_view(i))
            for i, c in enumerate(sweep.configs)]).headline_ratios()
    errs = {}
    for name in TIMING_W3:
        got, want = ratios(card[name]), ratios(exact[name])
        errs[name] = max(abs(got[k] / v - 1.0) for k, v in want.items())
        check(errs[name] <= RTOL,
              f"explore_many {name}: headline ratios {errs[name]:.3g} "
              f"from the exact path")
    return {"phase": "explore_many", "launches": launches,
            "configs": len(card[TIMING_W3[0]]), "card_s": card_s,
            "cpu_s": cpu_s, "headline_max_rel_vs_exact": errs,
            "headline_card": {n: ratios(card[n]) for n in TIMING_W3}}


def _serving_kw(res, device) -> dict:
    """A search's serving setting, as objective_matrix takes it."""
    if res.stats.get("traffic") is None:
        return {}
    from repro_torch.serving.traffic import resolve_traffic
    return {"traffic": resolve_traffic(res.stats["traffic"]),
            "n_slots": res.stats["n_slots"], "device": device}


def _front_objectives_plain(res, workloads, device):
    """The front genomes of a search through the sweep kernel's plain
    version on the card, scored as the search scores them (a serving
    search's fleets through the fleet kernel on the card)."""
    import numpy as np
    import torch
    from repro_torch.core.dse_batch import (_cfg_to_device, _lay_to_device,
                                            _make_cfg_lay,
                                            _workload_batch_many,
                                            mixed_assign_cfg)
    from repro_torch.core.synthesis import synthesize_soa
    from repro_torch.core.workloads import get_workload
    from repro_torch.explore.objectives import (multi_objective_matrix,
                                                objective_matrix)
    from repro_torch.kernels.sweep_kernel import sweep_aggregates_ref
    wls = tuple(get_workload(w) for w in workloads)
    soa, assign = res.space.decode(res.genomes)
    multi = len(wls) > 1
    assigns = res.space.split_assign(assign) if multi else [assign]
    combined, bounds = _workload_batch_many(wls)
    cfg, lay = _make_cfg_lay(soa, synthesize_soa(soa), combined)
    cfg = mixed_assign_cfg(cfg, assign)
    agg = sweep_aggregates_ref(_cfg_to_device(cfg, device, False),
                               _lay_to_device(lay, device, False),
                               bounds=bounds)
    torch.cuda.synchronize(device)
    agg = {k: v.cpu().numpy() for k, v in agg.items()}
    macs = [np.array([l.macs for l in w.layers], dtype=np.float64)
            for w in wls]
    if multi:
        return multi_objective_matrix(agg, assigns, macs, res.objectives)
    one = {k: v[0] for k, v in agg.items()}
    one["area_mm2"] = cfg["area_mm2"][:, 0]
    return objective_matrix(one, assign, macs[0], res.objectives,
                            **_serving_kw(res, device))


def _first_divergence(card, cpu):
    """The first evaluation (row of ``all_objectives``) at which the two
    runs scored different genomes — objective rows more than 1e-4 apart —
    and its nsga2 generation; None where they never part."""
    import numpy as np
    a, b = card.all_objectives, cpu.all_objectives
    n = min(len(a), len(b))
    rel = np.abs(a[:n] - b[:n]) / np.maximum(np.abs(b[:n]), 1e-30)
    rows = np.nonzero((rel > 1e-4).any(axis=1))[0]
    if not len(rows):
        return None
    pop = len(card.population) if card.population is not None else 1
    return {"eval": int(rows[0]), "generation": int(rows[0]) // pop}


def _search_phase(name: str, spec, workloads, device) -> dict:
    """One search through run() on the card and on the exact CPU path:
    wall time, Evaluator stats, front size, kernel launches and, from a
    third (profiled) card run, the host time of the search's stages; every
    front row of the card's run re-scored on the exact path within 1e-6
    (held, column by column, to the plain version's own distance from the
    exact path plus 1e-6: ROADMAP C.1), accuracy_noise identical."""
    import numpy as np
    from repro_torch.core.dse import run
    from repro_torch.explore.objectives import SERVING_OBJECTIVES
    from repro_torch.explore.search import Evaluator
    from repro_torch.kernels import fleet_sim, sweep_kernel

    sweep_kernel.launches = 0
    fleet_sim.launches = 0
    t0 = time.perf_counter()
    card = run(spec, device=device)
    card_s = time.perf_counter() - t0
    launches = sweep_kernel.launches
    fleet_launches = fleet_sim.launches
    serving = card.stats["traffic"] is not None
    KEEP[name] = card
    KEEP[f"{name}_wall_s"] = card_s
    t0 = time.perf_counter()
    cpu = run(spec, device="cpu")
    cpu_s = time.perf_counter() - t0
    check(launches == card.stats["chunks"] >= 1,
          f"{name}: {launches} kernel launches for "
          f"{card.stats['chunks']} evaluation chunks")
    check(fleet_launches == (card.stats["chunks"] if serving else 0),
          f"{name}: {fleet_launches} fleet-kernel launches for "
          f"{card.stats['chunks']} evaluation chunks")
    check(card.stats["device"] == str(device) and cpu.stats["device"] ==
          "cpu", f"{name}: devices {card.stats['device']} / "
          f"{cpu.stats['device']}")
    check(card.n_evals == cpu.n_evals, f"{name}: evaluation counts")
    check(bool(np.isfinite(card.front_objectives).all()),
          f"{name}: non-finite front objectives")

    skw = _serving_kw(card, "cpu")
    exact = Evaluator(card.space, list(workloads) if len(workloads) > 1
                      else workloads[0], card.objectives, device="cpu",
                      **{k: v for k, v in skw.items() if k != "device"}
                      ).evaluate(card.genomes)
    plain = _front_objectives_plain(card, workloads, device)
    # serving columns: held apart, request by request (_ceil_flips)
    flips = (_ceil_flips(card, workloads[0], exact, device) if serving
             else None)
    cols = {}
    for j, obj in enumerate(card.objectives):
        if obj in SERVING_OBJECTIVES:
            continue
        got = rel_err(card.front_objectives[:, j], exact[:, j])
        plain_err = rel_err(plain[:, j], exact[:, j])
        cols[obj] = {"rel_vs_exact": got, "plain_rel_vs_exact": plain_err,
                     "rel_vs_plain": rel_err(card.front_objectives[:, j],
                                             plain[:, j])}
        check(got <= max(RTOL, plain_err + RTOL),
              f"{name}: front {obj} {got:.3g} from the exact path, beyond "
              f"the float32 policy's {plain_err:.3g}")
    acc = [j for j, o in enumerate(card.objectives) if "accuracy" in o]
    for j in acc:
        check(np.array_equal(card.front_objectives[:, j], exact[:, j]),
              f"{name}: accuracy_noise differs between card and CPU")
    same = (card.genomes.shape == cpu.genomes.shape
            and bool(np.array_equal(card.genomes, cpu.genomes)))

    # where a card search's host time goes: one more card run under
    # cProfile, cumulative seconds of the search's stages
    import cProfile
    import pstats
    prof = cProfile.Profile()
    prof.enable()
    run(spec, device=device)
    prof.disable()
    cum = {}
    for (path, _, fn), row in pstats.Stats(prof).stats.items():
        if "repro_torch" in path and fn in SEARCH_STAGES:
            cum[fn] = cum.get(fn, 0.0) + row[3]

    def report(res, wall):
        st = dict(res.stats)
        st["wall_s"] = wall
        st["evals_per_s"] = res.n_evals / wall
        st["kernel_evals_per_eval_s"] = (
            st["kernel_evals"] / st["eval_seconds"]
            if st["eval_seconds"] else None)
        st["front_size"] = res.front_size
        return st
    return {"phase": name, "launches": launches,
            "fleet_launches": fleet_launches, "ceil_flips": flips,
            "card": report(card, card_s), "cpu": report(cpu, cpu_s),
            "fronts_identical": same,
            "first_divergence": None if same
            else _first_divergence(card, cpu),
            "host_profile_s": cum,
            "hypervolume_card": card.hypervolume(cpu.ref_point),
            "hypervolume_cpu": cpu.hypervolume(),
            "front_vs_exact": cols}


def phase_coexplore(device) -> dict:
    from repro_torch.core.dse import ExploreSpec
    c = COEXPLORE
    return _search_phase("coexplore", ExploreSpec.mixed(
        c["workload"], preset=c["preset"], seed=c["seed"]),
        (c["workload"],), device)


def phase_coexplore_many(device) -> dict:
    from repro_torch.core.dse import ExploreSpec
    c = COEXPLORE_MANY
    return _search_phase("coexplore_many", ExploreSpec.many(
        c["workloads"], precision="mixed", preset=c["preset"],
        seed=c["seed"]), c["workloads"], device)


def phase_coexplore_golden(device) -> dict:
    """The setting of tests/golden_coexplore_many.json on the card and on
    the exact CPU path: front genomes identical to the golden's in both;
    the CPU's objectives within 1e-9 of it, the card's (float32
    aggregates) within 1e-6."""
    import numpy as np
    from repro_torch.core.dse import ExploreSpec, run
    from repro_torch.kernels import sweep_kernel

    golden = json.loads(GOLDEN.read_text())
    spec = ExploreSpec.many(
        golden["workloads"], precision="mixed", preset=golden["preset"],
        budget=golden["budget"], seed=golden["seed"],
        pop_size=golden["pop_size"])
    sweep_kernel.launches = 0
    card = run(spec, device=device)
    launches = sweep_kernel.launches
    cpu = run(spec, device="cpu")
    want_g = card.space.unpack_genomes(
        np.array(golden["front_genomes_u16"], dtype=np.uint16))
    want_f = np.array(golden["front_objectives"], dtype=np.float64)
    check(list(card.objectives) == golden["objectives"],
          "golden: objective names")
    check(launches == card.stats["chunks"] >= 1,
          f"golden: {launches} launches for {card.stats['chunks']} chunks")
    for res, tol, where in ((card, RTOL, "card"), (cpu, GOLDEN_RTOL, "cpu")):
        check(res.genomes.shape == want_g.shape
              and bool(np.array_equal(res.genomes, want_g)),
              f"golden: the {where}'s front genomes differ from the golden")
        err = rel_err(res.front_objectives, want_f)
        check(err <= tol, f"golden: the {where}'s front objectives "
              f"{err:.3g} from the golden (> {tol})")
    return {"phase": "coexplore_golden", "launches": launches,
            "chunks": card.stats["chunks"], "front_size": card.front_size,
            "fronts_identical": True,
            "card_rel_vs_golden": rel_err(card.front_objectives, want_f),
            "cpu_rel_vs_golden": rel_err(cpu.front_objectives, want_f)}


# --------------------------------------------- the serving-fleet simulator

def _chunk_fleet_inputs(device):
    """The latency_s / energy_j aggregates of the main path's first
    32768-config chunk (VGG-16), from the sweep kernel on the card, as the
    fleet's seconds an iteration and joules a token-slot."""
    import torch
    from repro_torch.core.dse_batch import (_cfg_to_device, _lay_to_device,
                                            _make_cfg_lay, _workload_batch)
    from repro_torch.core.synthesis import synthesize_soa
    from repro_torch.core.workloads import get_workload
    from repro_torch.kernels.sweep_kernel import sweep_aggregates
    soa = next(iter(grid(GRID_STREAM)))
    cfg, lay = _make_cfg_lay(soa, synthesize_soa(soa),
                             _workload_batch(get_workload("vgg16")))
    agg = sweep_aggregates(_cfg_to_device(cfg, device, False),
                           _lay_to_device(lay, torch.device("cpu"), False))
    return (agg["latency_s"].double().cpu().numpy(),
            agg["energy_j"].double().cpu().numpy())


def _fleet_device_inputs(step, trace, device):
    import torch
    return (torch.from_numpy(step).to(device),
            torch.from_numpy(trace.arrival_s).to(device),
            torch.from_numpy(trace.service_iters).to(device))


def phase_fleet_parity(device) -> dict:
    """The fleet kernel on one chunk of the main path's aggregates under
    the steady, bursty and interactive traces at 1, 8 and more slots than
    it keeps in registers, and in a serving window that cuts each trace:
    stamps and every metrics() column equal to the plain version's on the
    card bit for bit, and a seeded sample of candidates equal to the
    event-driven scalar oracle's."""
    import dataclasses
    import numpy as np
    from repro_torch.kernels import fleet_sim
    from repro_torch.serving.fleet_sim import (simulate_fleet,
                                               simulate_fleet_scalar)
    from repro_torch.serving.traffic import resolve_traffic

    step, etok = _chunk_fleet_inputs(device)
    KEEP["fleet_chunk"] = (step, etok)
    rng = np.random.default_rng(FLEET_SAMPLE_SEED)
    wide = fleet_sim.MAX_REGISTER_SLOTS + 1
    runs = [(t, s, None) for t in FLEET_TRACES for s in (1, 8, wide)]
    runs += [(t, 8, FLEET_CUT_ITERS) for t in FLEET_TRACES]
    fleet_sim.launches = 0
    cases = []
    worst = 0
    for name, n_slots, max_iters in runs:
        trace = resolve_traffic(name)
        t0 = time.perf_counter()
        res = simulate_fleet(step, etok, trace, n_slots=n_slots,
                             max_iters=max_iters, device=device)
        card_s = time.perf_counter() - t0
        check(res.backend == "cuda", f"fleet {name}: route {res.backend}")
        plain = fleet_sim.fleet_stamps_ref(
            *_fleet_device_inputs(step, trace, device), n_slots, res.n_iters)
        plain_res = dataclasses.replace(
            res, submit_iter=plain.submit.cpu().numpy(),
            comp_iter=plain.comp.cpu().numpy(),
            active_iters=plain.active.cpu().numpy())
        what = f"fleet {name}, {n_slots} slots, max_iters {max_iters}"
        for f in ("submit_iter", "comp_iter", "active_iters"):
            got, want = getattr(res, f), getattr(plain_res, f)
            check(np.array_equal(got, want),
                  f"{what}: kernel {f} differs from the plain version")
            worst = max(worst, int(np.max(np.abs(got - want))))
        m, pm = res.metrics(), plain_res.metrics()
        for k in m:
            check(m[k].tobytes() == pm[k].tobytes(),
                  f"{what}: metrics {k} differ from the plain version")
        idx = rng.choice(len(step), FLEET_SAMPLE, replace=False)
        for i in idx:
            one = simulate_fleet_scalar(step[i], etok[i], trace,
                                        n_slots=n_slots, max_iters=max_iters)
            check(np.array_equal(one.submit_iter[0], res.submit_iter[i])
                  and np.array_equal(one.comp_iter[0], res.comp_iter[i])
                  and one.active_iters[0] == res.active_iters[i],
                  f"{what}: candidate {i} differs from the scalar oracle")
        served = float(res.served.mean())
        if max_iters is not None:
            check(served < 1.0, f"{what}: the window cuts nothing")
        cases.append({"trace": name, "n_slots": n_slots,
                      "max_iters": max_iters, "n_iters": res.n_iters,
                      "grid": fleet_sim.last_grid, "card_s": card_s,
                      "served_frac": served,
                      "p99_latency_s_median": float(np.median(
                          m["p99_latency_s"]))})
    check(fleet_sim.launches == len(runs),
          f"fleet parity: {fleet_sim.launches} launches for {len(runs)} "
          f"simulations")
    return {"phase": "fleet_parity", "candidates": len(step),
            "launches": fleet_sim.launches, "scalar_sample": FLEET_SAMPLE,
            "max_abs_vs_plain": worst, "cases": cases}


def phase_fleet_timing(device) -> dict:
    """The fleet kernel at N = 32768 (the chunk) and N = 1,048,576 (the
    chunk tiled 32x), steady trace, 8 slots: profiler device time (the
    largest of three windows) of the kernel and of the call with its
    transposes, and CUDA events; beside its plain version on the card, the CPU route, the byte and
    issue bounds and the device-to-host copy of the stamps."""
    import numpy as np
    import torch
    from repro_torch.kernels import fleet_sim
    from repro_torch.serving.traffic import resolve_traffic

    step0, _ = KEEP["fleet_chunk"]
    trace = resolve_traffic("steady")
    r = trace.n_requests
    out = {"phase": "fleet_timing", "trace": trace.name,
           "n_slots": FLEET_SLOTS_TIMED, "requests": r}
    for tile in (1, FLEET_TILE):
        step = np.tile(step0, tile)
        n = len(step)
        args = _fleet_device_inputs(step, trace, device)
        n_iters = (int(np.ceil(trace.arrival_s.max() / step.min()))
                   + int(trace.service_iters.sum()) + 1)
        iters = 20 if tile == 1 else 5
        seen: dict = {}
        dev_ms, ev_ms = _device_ms(
            lambda i: fleet_sim.fleet_stamps(*args, FLEET_SLOTS_TIMED,
                                             n_iters),
            iters, windows=3, seen=seen)
        kern = [ms for key, ms in seen.get("top", ())
                if "fleet_sim_kernel" in key]
        row = {"n": n, "n_iters": n_iters,
               "kernel_ms": kern[0] if kern else None,
               "device_ms": dev_ms, "event_ms": ev_ms,
               "top": seen.get("top"), "grid": fleet_sim.last_grid}
        want = fleet_sim.fleet_stamps(*args, FLEET_SLOTS_TIMED, n_iters)
        plain_ms = []
        for _ in range(2):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            plain = fleet_sim.fleet_stamps_ref(*args, FLEET_SLOTS_TIMED,
                                               n_iters)
            torch.cuda.synchronize(device)
            plain_ms.append(1e3 * (time.perf_counter() - t0))
        check(all(torch.equal(a, b) for a, b in zip(want, plain)),
              f"fleet timing N = {n}: kernel differs from the plain version")
        d2h_ms = []
        for _ in range(3):
            stamps = fleet_sim.fleet_stamps(*args, FLEET_SLOTS_TIMED, n_iters)
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            host = [t.cpu() for t in stamps]
            d2h_ms.append(1e3 * (time.perf_counter() - t0))
        cpu_args = [a.cpu() for a in args]
        t0 = time.perf_counter()
        on_cpu = fleet_sim.fleet_stamps(*cpu_args, FLEET_SLOTS_TIMED,
                                        n_iters)
        cpu_ms = 1e3 * (time.perf_counter() - t0)
        check(all(torch.equal(a, b) for a, b in zip(host, on_cpu)),
              f"fleet timing N = {n}: CPU route differs from the kernel")
        # the least the card could take: the stamps written once (two
        # int64 a request and candidate), active and step_s once each, the
        # trace once; or the slot arg-mins' compare-selects at the CUDA
        # cores' 32-bit issue rate
        nbytes = 16 * n * r + 16 * n + 16 * r
        ops = n * r * FLEET_SLOTS_TIMED
        bytes_ms = 1e3 * nbytes / H100.hbm_bw
        ops_ms = 1e3 * ops / PEAK_F32_OPS_UNFUSED
        row.update(
            plain_ms=min(plain_ms), cpu_route_ms=cpu_ms,
            d2h_ms=min(d2h_ms), d2h_bytes=int(sum(t.numel() * 8
                                                 for t in host)),
            bytes=nbytes, compare_selects=ops, bytes_bound_ms=bytes_ms,
            issue_bound_ms=ops_ms, bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations")
        out[str(n)] = row
        del args, want, plain, stamps, host
        torch.cuda.empty_cache()
    return out


def phase_coexplore_serving(device) -> dict:
    """The serving-default search (nsga2, 2048 evaluations, population
    64, the steady trace, 8 slots) through run() on the card and the CPU:
    one sweep-kernel and one fleet-kernel launch per evaluation chunk."""
    from repro_torch.core.dse import ExploreSpec
    c = COEXPLORE_SERVING
    return _search_phase("coexplore_serving", ExploreSpec.mixed(
        c["workload"], preset=c["preset"], seed=c["seed"]),
        (c["workload"],), device)


def _ceil_flips(res, workload, exact_rows, device) -> dict:
    """A serving search's front rows on the card against the exact path,
    request by request.  The card's latency aggregates are float32 (within
    ~1e-6 of the exact path), and ``ceil(arrival_s / step_s)`` moves by
    one iteration wherever the quotient lies that close to an integer: a
    flip.  Every arrival iteration where the two paths differ must be one
    (the exact quotient within ``(|d step| / step) * arrival / step + 1
    ulp`` of an integer, ``step`` the smaller of the two); rows without a
    flip are held to the aggregates' own distance + 1e-6.  The fleet
    kernel fed the card's own steps equals its CPU route bit for bit."""
    import numpy as np
    from repro_torch.core.dse_batch import _sweep_mixed
    from repro_torch.core.workloads import get_workload
    from repro_torch.explore.objectives import (SERVING_OBJECTIVES,
                                                objective_matrix)
    from repro_torch.serving.fleet_sim import _arrival_iters, simulate_fleet

    wl = get_workload(workload)
    soa, assign = res.space.decode(res.genomes)
    macs = np.array([l.macs for l in wl.layers], dtype=np.float64)
    skw = _serving_kw(res, device)
    card = _sweep_mixed(wl, soa, assign, device=device)
    exact = _sweep_mixed(wl, soa, assign, device="cpu")
    replay = objective_matrix(card, assign, macs, res.objectives, **skw)
    check(replay.tobytes() == res.front_objectives.tobytes(),
          "serving front: re-scoring the card's rows on the card moved them")
    trace, n_slots = skw["traffic"], skw["n_slots"]
    step_c = np.asarray(card["latency_s"], np.float64)
    step_e = np.asarray(exact["latency_s"], np.float64)
    etok_c = np.asarray(card["energy_j"], np.float64)
    etok_e = np.asarray(exact["energy_j"], np.float64)
    on_card = simulate_fleet(step_c, etok_c, trace, n_slots=n_slots,
                             device=device)
    on_cpu = simulate_fleet(step_c, etok_c, trace, n_slots=n_slots,
                            device="cpu")
    for f in ("submit_iter", "comp_iter", "active_iters"):
        check(np.array_equal(getattr(on_card, f), getattr(on_cpu, f)),
              f"serving front: fleet kernel {f} differs from the CPU route")
    a_c = _arrival_iters(step_c, trace.arrival_s)
    a_e = _arrival_iters(step_e, trace.arrival_s)
    rows, reqs = np.nonzero(a_c != a_e)
    x = trace.arrival_s[reqs] / step_e[rows]
    rel_step = (np.abs(step_c - step_e) / np.minimum(step_c, step_e))[rows]
    tol = rel_step * x + np.spacing(x)
    margin = np.abs(x - np.round(x)) / tol
    explained = (np.abs(a_c - a_e)[rows, reqs] == 1) & (margin <= 1.0)
    check(bool(explained.all()),
          f"serving front: {int((~explained).sum())} arrival iterations "
          f"differ from the exact path without a ceil flip to explain them")
    flipped = np.zeros(len(step_c), dtype=bool)
    flipped[rows] = True
    keep = ~flipped
    agg_rel = (max(rel_err(step_c[keep], step_e[keep]),
                   rel_err(etok_c[keep], etok_e[keep]))
               if keep.any() else None)
    cols = {}
    for j, obj in enumerate(res.objectives):
        if obj not in SERVING_OBJECTIVES:
            continue
        got, want = res.front_objectives[:, j], exact_rows[:, j]
        unflipped = rel_err(got[keep], want[keep]) if keep.any() else None
        cols[obj] = {"rel_vs_exact_all_rows": rel_err(got, want),
                     "rel_vs_exact_unflipped_rows": unflipped,
                     "bound_unflipped": None if agg_rel is None
                     else max(RTOL, agg_rel + RTOL)}
        if keep.any():
            check(unflipped <= max(RTOL, agg_rel + RTOL),
                  f"serving front: {obj} {unflipped:.3g} from the exact path "
                  f"on rows without a ceil flip (aggregates {agg_rel:.3g})")
    return {"front_rows": len(step_c), "requests": trace.n_requests,
            "flips": int(len(rows)), "flipped_rows": int(flipped.sum()),
            "unexplained": int((~explained).sum()),
            "worst_margin": float(margin.max()) if len(rows) else None,
            "aggregates_rel_vs_exact_unflipped": agg_rel,
            "stamps_card_eq_cpu": True, "columns": cols}


def phase_serving_front_shift(device) -> dict:
    """The reference bench's claim (benchmarks/serving_dse_bench.py) on the
    card: for each trace, the serving objectives' front genome set differs
    from the per-inference EDP front's on at least one trace.  Budget
    1024, population 48, seed 0, VGG-16, on the card and the CPU."""
    from repro_torch.core.dse import ExploreSpec, run
    from repro_torch.kernels import fleet_sim

    c = FRONT_SHIFT

    def campaign(dev, traffic, objectives):
        spec = ExploreSpec.mixed(
            "vgg16", preset="quick", budget=c["budget"], seed=c["seed"],
            objectives=objectives, traffic=traffic, pop_size=c["pop_size"])
        t0 = time.perf_counter()
        res = run(spec, device=dev)
        return res, time.perf_counter() - t0

    def genomes(res):
        return {g.tobytes() for g in res.genomes}

    out = {"phase": "serving_front_shift", **c, "traces": {}}
    for dev in (device, "cpu"):
        base, base_s = campaign(dev, None, EDP_OBJS)
        out[f"edp_{'card' if dev != 'cpu' else 'cpu'}"] = {
            "front_size": base.front_size,
            "evals_per_s": base.n_evals / base_s}
        for trace in FLEET_TRACES:
            fleet_sim.launches = 0
            res, wall = campaign(dev, trace, SERVING_OBJS)
            if dev != "cpu":
                check(fleet_sim.launches == res.stats["chunks"] >= 1,
                      f"front shift {trace}: {fleet_sim.launches} fleet "
                      f"launches for {res.stats['chunks']} chunks")
            row = out["traces"].setdefault(trace, {})
            key = "card" if dev != "cpu" else "cpu"
            row[key] = {"front_size": res.front_size,
                        "evals_per_s": res.n_evals / wall,
                        "shifted_vs_edp": genomes(res) != genomes(base)}
            KEEP[f"shift_{key}_{trace}"] = res
        KEEP[f"shift_{'card' if dev != 'cpu' else 'cpu'}_edp"] = base
    for trace in (*out["traces"], "edp"):
        a, b = KEEP[f"shift_card_{trace}"], KEEP[f"shift_cpu_{trace}"]
        same = (a.genomes.shape == b.genomes.shape
                and bool((a.genomes == b.genomes).all()))
        row = out["traces"][trace] if trace != "edp" else out["edp_card"]
        row["fronts_identical"] = same
        row["first_divergence"] = (None if same
                                   else _first_divergence(a, b))
    shifted = [t for t, row in out["traces"].items()
               if row["card"]["shifted_vs_edp"]]
    check(bool(shifted), "serving front shift: the serving front equals "
          "the EDP front on every trace")
    out["shifted_on_card"] = shifted
    return out


def phase_scalar_oracle() -> dict:
    """The reference's per-config scalar model on the paper's 720-point
    space (VGG-16) on the host, against the exact batched path (bit for
    bit) and the main path's card points (<= 1e-6 relative)."""
    from repro_torch.core.dse import ExploreSpec, run
    t0 = time.perf_counter()
    scalar = run(ExploreSpec.single("vgg16", engine="scalar"), device="cpu")
    scalar_s = time.perf_counter() - t0
    exact = run(ExploreSpec.single("vgg16"), device="cpu")
    card = KEEP["points"]
    props = ("perf_per_area", "energy_j", "latency_s", "total_cycles")
    check(len(scalar.points) == len(exact.points) == len(card.points) == 720,
          "scalar oracle: point counts")
    worst = 0.0
    for s, e, c in zip(scalar.points, exact.points, card.points):
        check(s.config.name() == e.config.name() == c.config.name(),
              "scalar oracle: config order")
        for prop in props:
            check(getattr(s.result, prop) == getattr(e.result, prop),
                  f"scalar oracle: {prop} differs from the exact path")
        check(all(a == b for a, b in zip(s.result.layers, e.result.layers)),
              "scalar oracle: layers differ from the exact path")
        worst = max(worst, max(abs(getattr(c.result, p)
                                   / getattr(s.result, p) - 1.0)
                               for p in props))
    check(worst <= RTOL, f"scalar oracle: card points {worst:.3g} from it")
    ratios = scalar.headline_ratios()
    check(ratios == exact.headline_ratios(),
          "scalar oracle: headline ratios differ from the exact path")
    return {"phase": "scalar_oracle", "points": len(scalar.points),
            "scalar_s": scalar_s, "card_max_rel_vs_scalar": worst,
            "headline_identical_to_exact": True, "headline": ratios}


# ------------------------------------------------- PPA models and RTL

def _ppa_configs():
    from repro_torch.core.accelerator import design_space
    from repro_torch.core.pe import PEType
    cfgs = list(design_space())
    return cfgs, {t: [c for c in cfgs if c.pe_type == t] for t in PEType}


def phase_ppa(device) -> dict:
    """The paper's Fig. 2 on the card: the polynomial PPA suite fitted on
    the 720-point space per PE type, on the card and on the CPU; the same
    (degree, lambda) for all 12 models, the card's cv_rmse, r2, mape and
    predictions within float64 solve rounding of the CPU's, the
    reference test's bars; fit, prediction and oracle times."""
    import numpy as np
    import torch
    from repro_torch.core.ppa_model import TARGETS, fit_ppa_suite
    from repro_torch.core.synthesis import synthesize

    cfgs, by_type = _ppa_configs()
    fit_s = {}
    for key, dev in (("card_cold", device), ("card", device),
                     ("cpu", "cpu")):
        t0 = time.perf_counter()
        suite, stats = fit_ppa_suite(by_type, device=dev)
        if dev is device:
            torch.cuda.synchronize(device)
        fit_s[key] = time.perf_counter() - t0
        if key == "card":
            card_suite, card_stats = suite, stats
    cpu_suite, cpu_stats = suite, stats
    check(list(card_stats) == list(cpu_stats) and len(card_stats) == 12,
          "ppa: model keys")
    rel = {"cv_rmse": 0.0, "r2": 0.0, "mape": 0.0}
    models = {}
    for key, c in card_stats.items():
        h = cpu_stats[key]
        check((c["degree"], c["lam"]) == (h["degree"], h["lam"]),
              f"ppa {key}: card picked ({c['degree']}, {c['lam']}), CPU "
              f"({h['degree']}, {h['lam']})")
        for m in rel:
            rel[m] = max(rel[m], abs(c[m] - h[m]) / abs(h[m]))
        check(c["r2"] > PPA_R2_MIN and c["mape"] < PPA_MAPE_MAX,
              f"ppa {key}: r2 {c['r2']:.4f} / mape {c['mape']:.4f} miss "
              f"the reference's bars")
        models[key] = {k: c[k] for k in ("degree", "lam", "r2", "mape",
                                         "cv_rmse")}
    card_pred = card_suite.predict_batch(cfgs)
    cpu_pred = cpu_suite.predict_batch(cfgs)
    rel["predictions"] = max(rel_err(card_pred[t], cpu_pred[t])
                             for t in TARGETS)
    for m, v in rel.items():
        check(v <= PPA_RTOL, f"ppa: card {m} {v:.3g} from the CPU's")
    for t in TARGETS:
        check(bool(np.all(np.isfinite(card_pred[t]))), f"ppa: {t} finite")

    def per_design_us(fn, reps):
        fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps / len(cfgs) * 1e6
    predict_us = {
        "card": per_design_us(lambda: card_suite.predict_batch(cfgs), 20),
        "cpu": per_design_us(lambda: cpu_suite.predict_batch(cfgs), 20)}
    oracle_us = per_design_us(lambda: [synthesize(c) for c in cfgs], 3)
    return {"phase": "ppa", "n_configs": len(cfgs), "fit_s": fit_s,
            "card_vs_cpu_max_rel": rel, "models": models,
            "predict_batch_us_per_design": predict_us,
            "oracle_synthesize_us_per_design": oracle_us,
            "oracle_over_predict_card": oracle_us / predict_us["card"]}


def phase_rtl() -> dict:
    """The Verilog of each PE type's default config and of the first
    config of the main path's front: structural stats and a sha256 of
    each (the byte identity to the reference is a CPU test)."""
    import hashlib
    from repro_torch.core.accelerator import AcceleratorConfig
    from repro_torch.core.pe import PEType
    from repro_torch.core.rtl import generate_rtl, rtl_stats

    designs = {t.value: AcceleratorConfig(pe_type=t) for t in PEType}
    front = KEEP["stream"].front_configs()[0]
    designs["main_path_front_0"] = front
    out = {}
    for key, cfg in designs.items():
        text = generate_rtl(cfg)
        st = rtl_stats(text)
        check(st["modules"] == st["endmodules"] == 6,
              f"rtl {key}: {st['modules']} modules / {st['endmodules']} "
              f"endmodules")
        multiplier_free = cfg.pe_type in (PEType.LIGHTPE1, PEType.LIGHTPE2)
        check(st["has_shift"] == multiplier_free,
              f"rtl {key}: shift datapath")
        out[key] = dict(st, config=cfg.name(),
                        sha256=hashlib.sha256(text.encode()).hexdigest())
    return {"phase": "rtl", "designs": out}


# ------------------------------------------ the preemption-safe runtime

def _stream_summary(res, cache) -> dict:
    return {"n_configs": res.n_configs, "n_chunks": res.n_chunks,
            "front_size": res.front_size,
            "cache_hits": cache.hits, "cache_misses": cache.misses}


def _check_same_stream(what: str, got, got_cache, want, want_cache):
    check((got.n_configs, got.n_chunks) == (want.n_configs, want.n_chunks),
          f"{what}: {got.n_configs} configs / {got.n_chunks} chunks, "
          f"uninterrupted {want.n_configs} / {want.n_chunks}")
    for m in want.front_metrics:
        check(got.front_metrics[m].tobytes()
              == want.front_metrics[m].tobytes(), f"{what}: front {m}")
    for k in want.front_soa:
        check(got.front_soa[k].tobytes() == want.front_soa[k].tobytes(),
              f"{what}: front {k}")
    if want_cache is not None:
        check((got_cache.hits, got_cache.misses)
              == (want_cache.hits, want_cache.misses),
              f"{what}: cache hits/misses {got_cache.hits}/"
              f"{got_cache.misses}, uninterrupted {want_cache.hits}/"
              f"{want_cache.misses}")


def _snapshot_steps(ckpt_dir) -> list:
    import os
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def resume_child(ckpt_dir: str, cache_path: str) -> int:
    """The child of the ``resume`` phase: stream the main path's grid on
    the card with snapshots until the parent kills it."""
    import torch
    from repro_torch.core.synthesis import PersistentSynthesisCache
    from repro_torch.core.workloads import get_workload
    from repro_torch.runtime.dse_checkpoint import resume_sweep
    resume_sweep(get_workload("vgg16"), lambda: grid(GRID_STREAM),
                 checkpoint_dir=ckpt_dir, checkpoint_every=RESUME_EVERY,
                 cache=PersistentSynthesisCache(cache_path),
                 chunk_size=CHUNK, device=torch.device("cuda", 0))
    return 0


class _LateChunks:
    """Queue a spin kernel (``torch.cuda._sleep``) ahead of every chunk
    the stream dispatches, so its results come back late on the card: the
    device-side stall the watchdog exists for."""

    def __init__(self, cycles: int):
        self.cycles = cycles

    def __enter__(self):
        import torch
        from repro_torch.core import dse_batch
        self.real = real = dse_batch._dispatch_chunk

        def late(cfg, klay, device):
            torch.cuda._sleep(self.cycles)
            return real(cfg, klay, device)
        dse_batch._dispatch_chunk = late
        return self

    def __exit__(self, *exc):
        from repro_torch.core import dse_batch
        dse_batch._dispatch_chunk = self.real
        return False


def phase_resume(device) -> dict:
    """The main path's 1,029,600-config stream through the preemption-safe
    runtime on the card, each run against an uninterrupted card run with
    the same cache setup: (a) resume_sweep through injected failures,
    (b) a child process SIGKILLed after two snapshots and resumed here,
    (c) a watchdog deadline that fires, every re-dispatch a launch of the
    CUDA kernel; (d) the default search resumed through an injected
    failure, against the coexplore phase's uninterrupted card search."""
    import os
    import signal
    import tempfile
    import numpy as np
    from repro_torch.configs.coexplore_presets import get_preset
    from repro_torch.core import dse as D
    from repro_torch.core.dse_batch import _sweep_chunked
    from repro_torch.core.synthesis import PersistentSynthesisCache
    from repro_torch.core.workloads import get_workload
    from repro_torch.explore.accuracy import resolve_accuracy
    from repro_torch.explore.space import space_for_workload
    from repro_torch.kernels import sweep_kernel
    from repro_torch.runtime.dse_checkpoint import (resume_search,
                                                    resume_sweep)

    wl = get_workload("vgg16")
    feed = lambda: grid(GRID_STREAM)                     # noqa: E731
    out = {"phase": "resume"}
    with tempfile.TemporaryDirectory() as tmp:
        # the uninterrupted card run with a persisted cache
        ref_cache = PersistentSynthesisCache(os.path.join(tmp, "ref.npz"))
        sweep_kernel.launches = 0
        t0 = time.perf_counter()
        ref = _sweep_chunked(wl, feed(), device=device, chunk_size=CHUNK,
                             cache=ref_cache)
        out["uninterrupted"] = dict(_stream_summary(ref, ref_cache),
                                    wall_s=time.perf_counter() - t0,
                                    launches=sweep_kernel.launches)
        main = KEEP["stream"]
        check(ref.front_soa.keys() == main.front_soa.keys() and all(
            np.array_equal(ref.front_soa[k], main.front_soa[k])
            for k in main.front_soa),
            "resume: the uninterrupted front's configs differ from "
            "main_path's")

        # (a) injected failures at chunk boundaries
        cache = PersistentSynthesisCache(os.path.join(tmp, "a.npz"))
        sweep_kernel.launches = 0
        t0 = time.perf_counter()
        got = resume_sweep(wl, feed, checkpoint_dir=os.path.join(tmp, "a"),
                           checkpoint_every=RESUME_EVERY,
                           fail_at=dict(RESUME_FAIL_AT), cache=cache,
                           chunk_size=CHUNK, device=device)
        wall = time.perf_counter() - t0
        launches = sweep_kernel.launches
        _check_same_stream("resume (a)", got, cache, ref, ref_cache)
        check(got.timings["restarts"] == sum(RESUME_FAIL_AT.values()),
              f"resume (a): {got.timings['restarts']} restarts")
        check(launches >= got.n_chunks, f"resume (a): {launches} launches")
        out["injected"] = dict(_stream_summary(got, cache), wall_s=wall,
                               launches=launches,
                               restarts=got.timings["restarts"],
                               fail_at={str(k): v for k, v in
                                        RESUME_FAIL_AT.items()})

        # (b) a real preemption: SIGKILL a streaming child process
        ck = os.path.join(tmp, "b")
        cache_b = os.path.join(tmp, "b.npz")
        t0 = time.perf_counter()
        child = subprocess.Popen(
            [sys.executable, str(pathlib.Path(__file__).resolve()),
             CHILD_FLAG, ck, cache_b], cwd=str(ROOT))
        try:
            while len(_snapshot_steps(ck)) < KILL_AFTER_SNAPSHOTS:
                check(child.poll() is None,
                      f"resume (b): the child ended ({child.returncode}) "
                      f"before {KILL_AFTER_SNAPSHOTS} snapshots")
                check(time.perf_counter() - t0 < 300,
                      "resume (b): no snapshots from the child in 300 s")
                time.sleep(0.005)
            alive = child.poll() is None
            child.send_signal(signal.SIGKILL)
        finally:
            if child.poll() is None:
                child.kill()
            child.wait()
        child_s = time.perf_counter() - t0
        steps = _snapshot_steps(ck)
        check(alive and child.returncode == -signal.SIGKILL,
              f"resume (b): child exit {child.returncode}")
        check(max(steps) < ref.n_chunks,
              f"resume (b): the child finished (snapshot {max(steps)})")
        cache = PersistentSynthesisCache(cache_b)
        sweep_kernel.launches = 0
        t0 = time.perf_counter()
        got = resume_sweep(wl, feed, checkpoint_dir=ck,
                           checkpoint_every=RESUME_EVERY, cache=cache,
                           chunk_size=CHUNK, device=device)
        wall = time.perf_counter() - t0
        _check_same_stream("resume (b)", got, cache, ref, ref_cache)
        out["sigkill"] = dict(_stream_summary(got, cache),
                              snapshots_at_kill=steps, child_s=child_s,
                              resume_wall_s=wall,
                              launches=sweep_kernel.launches,
                              chunks_replayed=ref.n_chunks - max(steps))

        # (c) the watchdog: each chunk stalled on the card behind a spin
        # kernel, a deadline it misses; depth 1, so each chunk is
        # finalized right after its launch
        sweep_kernel.launches = 0
        t0 = time.perf_counter()
        import warnings
        with warnings.catch_warnings(record=True) as warned, \
                _LateChunks(WATCHDOG_SPIN_CYCLES):
            warnings.simplefilter("always")
            got = _sweep_chunked(wl, feed(), device=device,
                                 chunk_size=CHUNK, prefetch_depth=1,
                                 chunk_deadline_s=WATCHDOG_DEADLINE_S)
        wall = time.perf_counter() - t0
        launches = sweep_kernel.launches
        t = got.timings
        _check_same_stream("resume (c)", got, None, ref, None)
        check(t["watchdog_redispatches"] > 0,
              "resume (c): the watchdog never fired")
        check(launches == got.n_chunks + t["watchdog_redispatches"],
              f"resume (c): {launches} launches for {got.n_chunks} chunks "
              f"+ {t['watchdog_redispatches']} re-dispatches")
        out["watchdog"] = {
            "deadline_s": WATCHDOG_DEADLINE_S,
            "spin_cycles_ahead_of_each_chunk": WATCHDOG_SPIN_CYCLES,
            "wall_s": wall,
            "launches": launches, "n_chunks": got.n_chunks,
            "warnings": sum("watchdog" in str(w.message) for w in warned),
            **{k: t[k] for k in ("watchdog_redispatches",
                                 "abandoned_finalizers",
                                 "executor_replacements",
                                 "cancelled_recomputes", "kernel_busy_s",
                                 "kernel_wait_s")}}

        # (d) the default search resumed through an injected failure
        c = COEXPLORE
        p = get_preset(c["preset"])
        kwargs = D._search_kwargs(
            p, "nsga2", objectives=p.objectives, seed=c["seed"],
            device=device, chunk_size=p.chunk_size, ref_point=None,
            accuracy=None if p.accuracy is None
            else resolve_accuracy(p.accuracy))
        sweep_kernel.launches = 0
        t0 = time.perf_counter()
        res = resume_search(space_for_workload(c["workload"]),
                            get_workload(c["workload"]), p.budget,
                            checkpoint_dir=os.path.join(tmp, "d"),
                            fail_at_generation=dict(SEARCH_FAIL_AT),
                            **kwargs)
        wall = time.perf_counter() - t0
        want = KEEP["coexplore"]
        check(np.array_equal(res.genomes, want.genomes)
              and res.front_objectives.tobytes()
              == want.front_objectives.tobytes(),
              "resume (d): front differs from coexplore's")
        check(res.history == want.history,
              "resume (d): hypervolume history differs from coexplore's")
        check(res.stats["restarts"] == sum(SEARCH_FAIL_AT.values()),
              f"resume (d): {res.stats['restarts']} restarts")
        out["search"] = {"restarts": res.stats["restarts"], "wall_s": wall,
                         "uninterrupted_wall_s": KEEP["coexplore_wall_s"],
                         "launches": sweep_kernel.launches,
                         "chunks": res.stats["chunks"],
                         "front_size": res.front_size,
                         "n_evals": res.n_evals}
    return out


def _enclosing(ranges, points) -> int:
    """How many ``(start, end)`` ranges hold at least one of ``points``."""
    import bisect
    pts = sorted(points)
    n = 0
    for a, b in ranges:
        i = bisect.bisect_left(pts, a)
        n += int(i < len(pts) and pts[i] <= b)
    return n


def phase_telemetry(device) -> dict:
    """Span tracing on the card's stream and search: fronts and cache
    accounting identical with tracing on and off, the exported Chrome
    trace valid and carrying the stage spans, the tracing overhead on the
    stream (the smallest of three interleaved runs each way; the
    reference targets 2 %, not a gate), and, with ``torch_annotations``,
    how many ``sweep.kernel`` profiler ranges enclose a sweep-kernel
    launch."""
    import os
    import tempfile
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import obs
    from repro_torch.core.dse import ExploreSpec, run
    from repro_torch.core.synthesis import PersistentSynthesisCache
    from repro_torch.kernels import sweep_kernel

    def stream(telemetry):
        cache = PersistentSynthesisCache()
        t0 = time.perf_counter()
        res = run(ExploreSpec.single("vgg16", grid(GRID_STREAM),
                                     chunk_size=CHUNK, cache=cache,
                                     telemetry=telemetry), device=device)
        return res, cache, time.perf_counter() - t0

    obs.configure(enabled=False, reset=True)
    walls = {"on": [], "off": []}
    ref = ref_cache = None
    for _ in range(TELEMETRY_REPEATS):
        for mode in ("off", "on"):
            res, cache, wall = stream(mode == "on")
            walls[mode].append(wall)
            if ref is None:
                ref, ref_cache = res, cache
            else:
                _check_same_stream(f"telemetry ({mode})", res, cache, ref,
                                   ref_cache)
    n_spans = len(obs.get_tracer().spans())
    c = COEXPLORE
    t0 = time.perf_counter()
    search = run(ExploreSpec.mixed(c["workload"], preset=c["preset"],
                                   seed=c["seed"], telemetry=True),
                 device=device)
    search_s = time.perf_counter() - t0
    want = KEEP["coexplore"]
    check(np.array_equal(search.genomes, want.genomes)
          and search.front_objectives.tobytes()
          == want.front_objectives.tobytes()
          and search.history == want.history,
          "telemetry: the traced search differs from coexplore's")
    check(not obs.is_enabled(), "telemetry: tracing left on after run()")
    with tempfile.TemporaryDirectory() as tmp:
        doc = obs.export_chrome_trace(os.path.join(tmp, "trace.json"))
        problems = obs.validate_chrome_trace(
            json.loads(pathlib.Path(tmp, "trace.json").read_text()))
    check(not problems, f"telemetry: chrome trace invalid: {problems[:3]}")
    names = {}
    for e in doc["traceEvents"]:
        names[e["name"]] = names.get(e["name"], 0) + 1
    missing = [n for n in TRACE_SPANS if n not in names]
    check(not missing, f"telemetry: trace lacks spans {missing}")
    summary = obs.summarize()

    # one profiler window over a stream with the spans mirrored into it
    sweep_kernel.launches = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res, _, _ = stream({"torch_annotations": True})
        torch.cuda.synchronize(device)
    launches = sweep_kernel.launches
    ranges, kernels = [], []
    for e in prof.events():
        if e.name == "sweep.kernel" and e.device_type == DeviceType.CPU:
            ranges.append((e.time_range.start, e.time_range.end))
        elif "sweep_aggregates_kernel" in e.name \
                and e.device_type == DeviceType.CUDA:
            kernels.append(e.time_range.start)
    obs.configure(enabled=False, reset=True)
    on, off = min(walls["on"]), min(walls["off"])
    return {"phase": "telemetry", "stream_wall_s": walls,
            "overhead": on / off - 1.0, "overhead_target": 0.02,
            "spans_recorded_stream": n_spans, "search_wall_s": search_s,
            "search_uninterrupted_wall_s": KEEP["coexplore_wall_s"],
            "trace_events": len(doc["traceEvents"]),
            "trace_span_counts": {n: names[n] for n in TRACE_SPANS},
            "stage_seconds": {n: a["total_s"] for n, a in
                              summary["spans"].items()},
            "profiler": {"launches": launches,
                         "sweep_kernel_ranges": len(ranges),
                         "kernel_records": len(kernels),
                         "ranges_enclosing_a_kernel":
                         _enclosing(ranges, kernels)}}


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


def _sweep_cell_instructions(path):
    """SASS instructions one cell issues on the reciprocal-division path
    of the sweep kernel's uniform instantiation (``cuobjdump``): the cell
    loop (from the backward branch after its ``STS.64`` of the staged pair)
    less the integer-division path it branches over and the IEEE
    divisions' slow paths.  None where the SASS does not show that
    shape."""
    import re
    from repro_torch.kernels import _build
    tool = pathlib.Path(_build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "--dump-sass", str(path)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    fn = re.search(r"Function : \S*sweep_aggregates_kernelILb0E\S*\n"
                   r"(.*?)(?=\n\s*Function : |\Z)", sass, re.S)
    if fn is None:
        return None
    ins = [(int(m.group(1), 16), m.group(2)) for m in (
        re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", ln)
        for ln in fn.group(1).splitlines()) if m]

    def target(text):
        t = re.search(r"BRA\s+(?:!?U?P\w+,\s*)?(0x[0-9a-f]+)", text)
        return int(t.group(1), 16) if t else None
    store = next((a for a, t in ins if t.startswith("STS.64")), None)
    loop = next(((target(t), a) for a, t in ins
                 if store is not None and a > store
                 and (target(t) or a) < a), None)
    if loop is None:
        return None
    body = [(a, t) for a, t in ins if loop[0] <= a <= loop[1]]
    text_at = dict(body)
    skipped = set()
    for a, t in body:
        tg = target(t)
        if not t.startswith("@") or tg is None or not a < tg <= loop[1]:
            continue
        span = {x for x, _ in body if a < x < tg}
        before = text_at.get(tg - 16, "")
        jumps_over = (before.startswith("BRA")
                      and (target(before) or 0) > tg)
        if jumps_over or any("CALL" in text_at[x] for x in span):
            skipped |= span
    return len(body) - len(skipped)


def _timing_inputs(shape: str):
    """The first 32768-config chunk of the 102,960-config grid: VGG-16
    with uniform or mixed ``(N, 16)`` precision columns, or VGG-16 +
    ResNet-34 + ResNet-50 in three segments; or the search's launch
    (``search_*``): 64 genomes with mixed columns, on VGG-16 or on the
    three segments."""
    import numpy as np
    from repro_torch.core.dse_batch import _make_cfg_lay, _workload_batch
    from repro_torch.core.pe import PEType, pe_spec
    from repro_torch.core.synthesis import synthesize_soa
    from repro_torch.core.workloads import get_workload
    names = TIMING_W3 if shape.endswith("w3") else ("vgg16",)
    wbs = [_workload_batch(get_workload(w)) for w in names]
    lay = {k: np.concatenate([w.arrays[k] for w in wbs])[None, :]
           for k in wbs[0].arrays}
    bounds, s = [], 0
    for w in wbs:
        bounds.append((s, s + len(w)))
        s += len(w)
    if shape.startswith("search"):
        # one generation of the search: SEARCH_N genomes of the joint
        # space, their hardware synthesized and their modes per layer
        from repro_torch.core.dse_batch import mixed_assign_cfg
        from repro_torch.explore.space import space_for_workloads
        space = space_for_workloads(names)
        soa, assign = space.decode(space.random_population(
            SEARCH_N, np.random.default_rng(0)))
        cfg, _ = _make_cfg_lay(soa, synthesize_soa(soa), wbs[0])
        return mixed_assign_cfg(cfg, assign), lay, tuple(bounds)
    soa = next(iter(grid(GRID_FULL)))
    cfg, _ = _make_cfg_lay(soa, synthesize_soa(soa), wbs[0])
    if shape == "mixed":
        specs = [pe_spec(t) for t in PEType]
        a = np.random.default_rng(20220516).integers(
            0, len(specs), size=(len(soa["pe_rows"]), s))
        cfg = dict(cfg,
                   act_bits=np.array([p.act_bits for p in specs])[a],
                   weight_bits=np.array([p.weight_bits for p in specs])[a],
                   mac_energy_pj=np.array([p.mac_energy_pj
                                           for p in specs])[a])
    return cfg, lay, tuple(bounds)


def phase_timing(device) -> dict:
    """Kernel device time vs its plain version at the main path's shape,
    and at the mixed-precision and W = 3 shapes, beside its bounds."""
    import torch
    from repro_torch.core.dse_batch import _cfg_to_device, _lay_to_device
    from repro_torch.kernels import _build
    from repro_torch.kernels import sweep_kernel as K

    lib = _build.library("sweep_kernel")
    cell_ins = _sweep_cell_instructions(_build.library_path("sweep_kernel"))
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0])
    stream = torch.cuda.current_stream(device).cuda_stream
    out = {"phase": "timing", "cell_instructions": cell_ins,
           "sm_clock_max_mhz": clock_mhz}
    for shape in TIMING_SHAPES:
        cfg, lay, bounds = _timing_inputs(shape)
        dcfg = _cfg_to_device(cfg, device, exact=False)
        hlay = _lay_to_device(lay, torch.device("cpu"), exact=False)
        dlay = _lay_to_device(lay, device, exact=False)
        n, l, w = len(cfg["pe_rows"]), int(hlay["r"].shape[1]), len(bounds)
        p = K.plan(n, bounds)
        K.sweep_aggregates_packed(dcfg, hlay, bounds=bounds)
        grid_launched = list(K.last_grid)
        check(grid_launched == [p.blocks, K.THREADS, p.smem],
              f"{shape}: launched grid {grid_launched} is not the plan's")

        # back-to-back launches of the kernel alone (table built once)
        table = torch.from_numpy(K._layer_table(hlay, bounds)).to(device)
        res = torch.empty((n, 6 * w), dtype=torch.float32, device=device)
        info = (ctypes.c_int * 3)()
        args = ([ctypes.c_void_p(dcfg[k].data_ptr())
                 for k in K.KERNEL_CFG_FIELDS]
                + [ctypes.c_void_p(table.data_ptr()),
                   ctypes.c_void_p(res.data_ptr()), n, l, w, p.blocks,
                   p.smem]
                + [int(dcfg[k].shape[1] != 1) for k in K.MIXED_CFG_FIELDS]
                + [info, ctypes.c_void_p(stream)])

        def launch():
            err = lib.qappa_sweep_aggregates(*args)
            if err != 0:
                raise RuntimeError(f"launch failed: CUDA error {err}")

        def plain():
            return K.sweep_aggregates_ref(dcfg, dlay, bounds=bounds)

        # plain, kernel, kernel, plain: both measured twice within this call
        plain_ms = [_event_ms(plain, 20)]
        kernel_ms = [_event_ms(launch, 500) for _ in range(2)]
        plain_ms.append(_event_ms(plain, 20))
        wrapper_ms = _event_ms(
            lambda: K.sweep_aggregates_packed(dcfg, hlay, bounds=bounds), 200)
        windows = [_profiled_kernel_ms(launch, 50) for _ in range(3)]
        kept = [x for x in windows if x is not None]

        n_read = len(K.KERNEL_CFG_FIELDS) + sum(
            int(dcfg[k].shape[1] != 1) for k in K.MIXED_CFG_FIELDS) * (l - 1)
        bytes_moved = n * (n_read * 4 + 6 * w * 4) + table.numel() * 4
        ops = n * l * F32_OPS_PER_CELL + n * w * F32_OPS_PER_CONFIG
        bytes_ms = bytes_moved / H100.hbm_bw * 1e3
        ops_ms = ops / PEAK_F32_OPS_UNFUSED * 1e3
        issue_ms = (None if cell_ins is None else
                    n * l / 32 * cell_ins
                    / (H100_SMS * 4 * clock_mhz * 1e6) * 1e3)
        out[shape] = {
            "n": n, "l": l, "w": w, "grid": grid_launched,
            "tiles": list(p.tiles), "kernel_ms": kernel_ms,
            "profiled_kernel_ms": min(kept) if kept else None,
            "profiler_windows": windows, "plain_ms": plain_ms,
            "wrapper_ms": wrapper_ms, "bytes": bytes_moved, "f32_ops": ops,
            "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "issue_bound_ms": issue_ms}
    return out


def _profiled_kernel_ms(fn, iters: int):
    """The sweep kernel's device time per launch from ``torch.profiler``
    over ``iters`` back-to-back launches; None where tracing kept none."""
    import torch
    try:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
    except (RuntimeError, AttributeError) as exc:   # tracing unavailable
        print(f"profiler unavailable: {exc}", file=sys.stderr)
        return None
    for ev in prof.key_averages():
        if "sweep_aggregates_kernel" in ev.key and ev.count:
            us = getattr(ev, "self_device_time_total", 0.0)
            return us / ev.count / 1e3 if us else None
    return None


# ---------------------------------------------------------------- serving

def _full_model(quant: str, device, impl: str = "auto"):
    """phi4-mini at full width in ``quant``, its params and prompts drawn
    as ``serve`` draws them."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(get_config(SERVE_ARCH), quant=quant)
    model = Model(cfg, device=device, impl=impl)
    params = model.init(torch.Generator(device).manual_seed(SERVE["seed"]),
                        quantize=True)
    prompts = torch.randint(
        0, cfg.vocab, (SERVE["batch"], SERVE["prompt_len"]), device=device,
        generator=torch.Generator(device).manual_seed(SERVE["seed"] + 1))
    return model, params, prompts


def _proj_bytes(quant: str) -> int:
    """Bytes of one step's quantized projection weights and scales."""
    from repro_torch.configs import get_config
    cfg = get_config(SERVE_ARCH)
    per_byte = 1.0 if quant == "w8a8" else 0.5
    return cfg.n_layers * sum(
        c * (int(k * n * per_byte) + 4 * n) for (k, n), c in
        LAYER_PROJ.items())


def _reset_matmul_counts() -> None:
    from repro_torch.kernels import w4a8_matmul, w8a8_matmul
    w4a8_matmul.launches = 0
    w8a8_matmul.launches = w8a8_matmul.launches_dp4a = 0
    w8a8_matmul.launches_tc = 0


def _matmul_counts() -> dict:
    from repro_torch.kernels import w4a8_matmul, w8a8_matmul
    return {"w8a8_matmul": w8a8_matmul.launches,
            "w8a8_matmul_dp4a": w8a8_matmul.launches_dp4a,
            "w8a8_matmul_tc": w8a8_matmul.launches_tc,
            "w4a8_matmul": w4a8_matmul.launches}


def phase_serve(device, quant: str) -> dict:
    """The serving path at full width; W8A8 through ``serve`` itself."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate, serve
    cfg = get_config(SERVE_ARCH)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    if quant == "w8a8":
        _reset_matmul_counts()
        res = serve(SERVE_ARCH, batch=SERVE["batch"],
                    prompt_len=SERVE["prompt_len"], gen=SERVE["gen"],
                    quantize=True, smoke=False, seed=SERVE["seed"],
                    device=device)
    else:   # serve() has no quant argument: the same loop on the model
        model, params, prompts = _full_model(quant, device)
        _reset_matmul_counts()
        res = generate(model, params, prompts, gen=SERVE["gen"])
        del model, params
    launches = _matmul_counts()
    wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device)
    steps = SERVE["prompt_len"] + SERVE["gen"]
    want = steps * cfg.n_layers * 7
    mine = "w8a8_matmul" if quant == "w8a8" else "w4a8_matmul"
    other = "w4a8_matmul" if quant == "w8a8" else "w8a8_matmul"
    check(launches[mine] == want,
          f"{mine} launched {launches[mine]} times, expected {want}")
    check(launches[other] == 0, f"{other} launched in the {quant} run")
    if quant == "w8a8":     # decode is m = batch: the split-k regime only
        check(launches["w8a8_matmul_dp4a"] == want
              and launches["w8a8_matmul_tc"] == 0,
              f"W8A8 regimes at decode: {launches}")
    toks = res["tokens"]
    check(tuple(toks.shape) == (SERVE["batch"], SERVE["gen"]),
          f"token shape {tuple(toks.shape)}")
    check(int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab,
          "tokens outside [0, vocab)")
    step_ms = res["decode_s"] / SERVE["gen"] * 1e3
    proj_bound_ms = _proj_bytes(quant) / H100.hbm_bw * 1e3
    # the logits product reads the float32 embedding (the reference's
    # bf16 matmul on it) on top of the projections
    embed_bytes = cfg.vocab * cfg.d_model * 4
    return {"phase": f"serve_{quant}", "launches": launches,
            "prefill_s": res["prefill_s"], "decode_s": res["decode_s"],
            "tok_per_s": res["tok_per_s"], "decode_step_ms": step_ms,
            "proj_bytes_per_step": _proj_bytes(quant),
            "proj_bound_ms": proj_bound_ms,
            "step_bound_ms": (_proj_bytes(quant) + embed_bytes)
            / H100.hbm_bw * 1e3,
            "wall_s_with_init": wall_s, "peak_mem_bytes": peak,
            "tokens_head": toks[0, :8].tolist()}


def _profile_device_ms(fn, iters: int):
    """Mean device time per call of ``fn(i)`` from ``torch.profiler``
    (all kernels and copies of the call), or None without device time;
    also the top kernels by device time, the device operations per call
    and the share of the expected kernel records the profiler kept.

    The profiler can drop records of a window: each kernel's time per
    call is its mean over the records kept times its launches per call
    (``ceil(count / iters)``), not its sum over ``iters``."""
    import math
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
    rows, ops, kept, expected = [], 0, 0, 0
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if us and ev.count:
            per_call = math.ceil(ev.count / iters)
            rows.append((us / ev.count * per_call, ev.key))
            ops += per_call
            kept += ev.count
            expected += per_call * iters
    total = sum(us for us, _ in rows)
    top = [[key[:60], us / 1e3] for us, key in sorted(rows, reverse=True)[:6]]
    return ((total / 1e3 if total else None), top, ops,
            kept / expected if expected else None)


class _ClockSampler:
    """Polls the SM clock and the power draw from ``nvidia-smi`` every
    0.1 s while the ``with`` block runs."""

    def __enter__(self):
        import threading
        self.samples, self.done = [], threading.Event()

        def poll():
            while not self.done.is_set():
                out = subprocess.run(
                    ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                     "--format=csv,noheader,nounits"], capture_output=True,
                    text=True, timeout=30).stdout.split(",")
                try:
                    self.samples.append([float(x) for x in out])
                except ValueError:
                    pass
                self.done.wait(0.1)
        self.thread = threading.Thread(target=poll, daemon=True)
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.done.set()
        self.thread.join(timeout=60)
        return False

    def summary(self) -> dict:
        mhz = [s[0] for s in self.samples]
        watts = [s[1] for s in self.samples]
        return {"samples": len(self.samples),
                "sm_mhz_min": min(mhz, default=None),
                "sm_mhz_max": max(mhz, default=None),
                "power_w_max": max(watts, default=None)}


def phase_serve_parity(device, quant: str) -> dict:
    """Kernel route vs plain route on the same full-width params and
    prompts, teacher-forced; then one profiled decode step."""
    import torch
    from repro_torch.models.model import Model
    kern, params, prompts = _full_model(quant, device, impl="kernel")
    plain = Model(kern.cfg, device=device, impl="ref")
    steps = PARITY_STEPS
    ck = kern.init_cache(SERVE["batch"], steps + 1)
    cp = plain.init_cache(SERVE["batch"], steps + 1)
    worst_abs, worst_scaled, same_tokens = 0.0, 0.0, True
    for i in range(steps):
        tok = prompts[:, i:i + 1]
        lk, ck = kern.decode_step(params, ck, tok, i)
        lp, cp = plain.decode_step(params, cp, tok, i)
        diff = float((lk.float() - lp.float()).abs().max())
        scale = float(lp.float().abs().max())
        check(bool(torch.isfinite(lk).all()), "non-finite logits")
        worst_abs = max(worst_abs, diff)
        worst_scaled = max(worst_scaled, diff / max(scale, 1e-30))
        same_tokens &= bool(torch.equal(lk.argmax(-1), lp.argmax(-1)))
    check(worst_scaled <= RTOL,
          f"{quant} logits kernel vs plain {worst_scaled:.3g} x max|logit|")
    check(same_tokens, f"{quant} greedy tokens differ between routes")
    caches_equal = bool(torch.equal(ck["k"], cp["k"])
                        and torch.equal(ck["v"], cp["v"]))
    # one decode step of the kernel route: wall time vs device busy time
    tok = prompts[:, steps:steps + 1]

    def step(_):
        kern.decode_step(params, ck, tok, steps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(0)
    torch.cuda.synchronize()
    step_wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, top, ops, _ = _profile_device_ms(step, BUSY_STEPS)
    return {"phase": f"serve_parity_{quant}", "steps": steps,
            "logits_max_abs": worst_abs, "logits_rel_to_max": worst_scaled,
            "greedy_tokens_identical": same_tokens,
            "caches_identical": caches_equal,
            "step_wall_ms": step_wall_ms, "step_device_ms": busy_ms,
            "device_busy_share": (busy_ms / step_wall_ms
                                  if busy_ms else None),
            "step_device_ops": ops,
            "step_top_kernels_ms": top}


def _qmm_operands(m, k, n, packed: bool, seed: int, device):
    import torch
    g = torch.Generator(device).manual_seed(seed)
    x = torch.randint(-127, 128, (m, k), generator=g, device=device,
                      dtype=torch.int32).to(torch.int8)
    w = torch.randint(-128, 128, (k // 2 if packed else k, n), generator=g,
                      device=device, dtype=torch.int32).to(torch.int8)
    xs = torch.rand((), generator=g, device=device) * 0.1 + 1e-3
    ws = torch.rand((n,), generator=g, device=device) * 0.1 + 1e-3
    return x, w, xs, ws


def _int_mm_witness(x, w, xs, ws):
    """W8A8 through ``torch._int_mm``: m padded to at least 32, k and n
    to multiples of 8 (zeros leave the int32 product unchanged), the
    weight column-major; then the plain version's epilogue."""
    import torch
    import torch.nn.functional as F
    m, k = x.shape
    n = w.shape[1]
    mp, kp, np_ = max(32, -(-m // 8) * 8), -(-k // 8) * 8, -(-n // 8) * 8
    xp = F.pad(x, (0, kp - k, 0, mp - m))
    wp = F.pad(w, (0, np_ - n, 0, kp - k)).t().contiguous().t()
    acc = torch._int_mm(xp, wp)[:m, :n]
    return acc.to(torch.float32) * xs * ws


def phase_qmatmul_parity(device) -> dict:
    """Kernel vs plain version, bit for bit, at the decode, ragged and
    (W8A8) prefill shapes; the worst errors by W8A8 regime."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import w4a8_matmul as W4
    from repro_torch.kernels.w8a8_matmul import plan
    both = (("w8a8", ops.w8a8_matmul), ("w4a8", ops.w4a8_matmul))
    shapes = [((SERVE["batch"], k, n), both) for k, n in LAYER_PROJ] \
        + [(shape, both) for shape in RAGGED] \
        + [(shape, both[:1]) for shape in W8A8_TC]
    rows = []
    worst = {"w8a8": [0.0, 0.0], "w4a8": [0.0, 0.0],
             "w8a8_dp4a": [0.0, 0.0], "w8a8_tc": [0.0, 0.0]}
    for i, ((m, k, n), modes) in enumerate(shapes):
        for mode, fn in modes:
            x, w, xs, ws = _qmm_operands(m, k, n, mode == "w4a8", i, device)
            got = fn(x, w, xs, ws, impl="kernel")
            want = fn(x, w, xs, ws, impl="ref")
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()), f"{mode} non-finite")
            d = (got.double() - want.double()).abs()
            err = float(d.max())
            rel = float((d / want.double().abs().clamp_min(1e-30)).max())
            row = {"mode": mode, "m": m, "k": k, "n": n, "max_abs": err,
                   "max_rel": rel}
            keys = [mode]
            if mode == "w8a8":
                row["regime"] = plan(m, k, n).regime
                keys.append(f"w8a8_{row['regime']}")
                lib = _int_mm_witness(x, w, xs, ws)
                row["int_mm_max_abs"] = float((got - lib).abs().max())
                check(row["int_mm_max_abs"] == 0.0,
                      f"w8a8 kernel vs torch._int_mm at {(m, k, n)}")
            else:       # the grid the C entry launched
                p = W4.plan(m, k, n)
                row["grid"] = list(W4.last_grid)
                check(W4.last_grid[2] == p.splits,
                      f"w4a8 at {(m, k, n)} launched {W4.last_grid}, "
                      f"planned {p}")
            check(bool(torch.equal(got, want)),
                  f"{mode} kernel not bit-identical to plain at {(m, k, n)}"
                  f" (max rel {rel:.3g})")
            for key in keys:
                worst[key] = [max(worst[key][0], err),
                              max(worst[key][1], rel)]
            rows.append(row)
            del x, w, got, want
    return {"phase": "qmatmul_parity", "rows": rows, "worst": worst}


def _device_ms(fn, iters: int, windows: int = 1,
               seen: dict | None = None) -> tuple[float, float]:
    """Per call of ``fn(i)``: device time from the profiler (None where
    it gives none) and CUDA-event time over back-to-back calls, which
    includes any host launch time the device waits on.  A profiler
    window that kept no record of the calls is taken again, twice at
    most.  With ``windows`` > 1, the largest of that many windows: a call
    of several kernels reads short in a window that dropped every record
    of one of them.  ``seen``, where given, receives the chosen window's
    top kernels (``top``) and device operations per call (``ops``)."""
    ms = None
    for _ in range(3 * windows):
        got, top, ops, _ = _profile_device_ms(fn, iters)
        if got is not None:
            if seen is not None and (ms is None or got > ms):
                seen.update(top=top, ops=ops)
            ms = got if ms is None else max(ms, got)
            windows -= 1
            if windows == 0:
                break
    cnt = [0]

    def call():
        cnt[0] += 1
        fn(cnt[0])
    return ms, _event_ms(call, iters)


def phase_qmatmul_timing(device) -> dict:
    """Device time per call at the m = 4 shapes, in turns (plain, kernel,
    kernel, plain); weights rotate through more than the L2 cache, as a
    decode step streams them cold."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import w4a8_matmul as W4
    from repro_torch.kernels import w8a8_matmul as W8
    m = SERVE["batch"]
    out = {"w8a8": {}, "w4a8": {}, "bf16_matmul_context_ms": {}}
    for (k, n) in LAYER_PROJ:
        for mode in ("w8a8", "w4a8"):
            packed = mode == "w4a8"
            wbytes = k * n // (2 if packed else 1)
            copies = -(-2 * L2_BYTES // wbytes) + 1
            x, _, xs, ws = _qmm_operands(m, k, n, packed, 7, device)
            wl = [_qmm_operands(m, k, n, packed, 100 + c, device)[1]
                  for c in range(copies)]
            if packed:
                kern, ref = W4.w4a8_matmul, W4.w4a8_matmul_ref
                # context only: a bf16 matmul on pre-decoded weights
                wd = [(W4.pow2_integers(w) * 2.0 ** -7 * ws).to(
                    torch.bfloat16) for w in wl]
                xb = (x.float() * xs).to(torch.bfloat16)
                out["bf16_matmul_context_ms"][f"{k}x{n}"] = _device_ms(
                    lambda i: torch.matmul(xb, wd[i % copies]), 100)
                del wd
                lib = None
            else:
                kern, ref = W8.w8a8_matmul, W8.w8a8_matmul_ref
                xp = F.pad(x, (0, 0, 0, 32 - m))
                wcol = [w.t().contiguous().t() for w in wl]
                lib = lambda i: torch._int_mm(xp, wcol[i % copies])
            row = {"copies": copies}
            if packed:      # what the C entry launched, held to the plan
                W4.last_grid = None
                kern(x, wl[0], xs, ws)
                p, grid = W4.plan(m, k, n), W4.last_grid
                row.update(grid=list(grid), splits=grid[2],
                           blocks=math.prod(grid))
                check(grid[2] == p.splits > 1
                      and row["blocks"] >= W8.SPLIT_TARGET_BLOCKS,
                      f"W4A8 at {(m, k, n)} launched {grid}, planned {p}")
            for name, fn, iters in (
                    ("plain", ref, 10), ("kernel", kern, 200),
                    ("kernel_again", kern, 200), ("plain_again", ref, 10)):
                row[f"{name}_ms"], row[f"{name}_event_ms"] = _device_ms(
                    lambda i, fn=fn: fn(x, wl[i % copies], xs, ws), iters)
            row["library_ms"] = row["library_event_ms"] = None
            if lib is not None:
                row["library_ms"], row["library_event_ms"] = _device_ms(
                    lib, 200)
                del wcol
            row.update(_bound((W4 if packed else W8).cost(m, k, n)))
            out[mode][f"{k}x{n}"] = row
            del wl

    def layer(mode, key):
        vals = [(c, out[mode][f"{k}x{n}"][key])
                for (k, n), c in LAYER_PROJ.items()]
        if any(v is None for _, v in vals):
            return None
        return sum(c * v for c, v in vals)
    # device time from the profiler; CUDA events where it gives none
    keys = ["kernel_ms", "kernel_again_ms", "plain_ms", "plain_again_ms"]
    timer = "profiler" if all(
        layer(mode, key) is not None for mode in ("w8a8", "w4a8")
        for key in keys) and layer("w8a8", "library_ms") is not None \
        else "event"
    suffix = "_ms" if timer == "profiler" else "_event_ms"
    for mode in ("w8a8", "w4a8"):
        bounds = {out[mode][f"{k}x{n}"]["bound_by"] for k, n in LAYER_PROJ}
        out[mode]["layer"] = {
            "kernel_ms": min(layer(mode, "kernel" + suffix),
                             layer(mode, "kernel_again" + suffix)),
            "plain_ms": min(layer(mode, "plain" + suffix),
                            layer(mode, "plain_again" + suffix)),
            "library_ms": layer(mode, "library" + suffix),
            "kernel_event_ms": min(layer(mode, "kernel_event_ms"),
                                   layer(mode, "kernel_again_event_ms")),
            "bound_ms": layer(mode, "bound_ms"),
            "bound_by": "bytes" if bounds == {"bytes"} else "operations",
            "bytes": layer(mode, "bytes")}
    return {"phase": "qmatmul_timing", "m": m, "timer": timer, **out}


def phase_qmatmul_prefill_timing(device) -> dict:
    """W8A8 at the prefill shape m = 4096 (the tensor-core regime): device
    time per call of the kernel, its float64 plain version and
    ``torch._int_mm`` at the four projection shapes, in turns (plain,
    kernel, kernel, plain); per layer, beside the bound (operations at
    the int8 peak; the weights stay in L2 at this m, so they are not
    rotated)."""
    import torch
    from repro_torch.kernels import w8a8_matmul as W8
    m = PREFILL_M
    out = {}
    for (k, n) in LAYER_PROJ:
        check(W8.plan(m, k, n).regime == "tc", f"m = {m} not on the tensor "
                                              f"cores at {(k, n)}")
        x, w, xs, ws = _qmm_operands(m, k, n, False, 9, device)
        wcol = w.t().contiguous().t()
        row = {}
        for name, fn, iters in (
                ("plain", lambda i: W8.w8a8_matmul_ref(x, w, xs, ws), 3),
                ("kernel", lambda i: W8.w8a8_matmul(x, w, xs, ws), 20),
                ("kernel_again", lambda i: W8.w8a8_matmul(x, w, xs, ws), 20),
                ("plain_again", lambda i: W8.w8a8_matmul_ref(x, w, xs, ws),
                 3),
                ("library", lambda i: torch._int_mm(x, wcol), 20)):
            row[f"{name}_ms"], row[f"{name}_event_ms"] = _device_ms(fn,
                                                                    iters)
        row.update(_bound(W8.cost(m, k, n)))
        out[f"{k}x{n}"] = row
        del x, w, wcol

    def layer(key):
        vals = [c * out[f"{k}x{n}"][key] for (k, n), c in LAYER_PROJ.items()]
        return None if any(v is None for v in vals) else sum(vals)
    keys = ["kernel", "kernel_again", "plain", "plain_again", "library"]
    timer = "profiler" if all(layer(f"{key}_ms") is not None
                              for key in keys) else "event"
    sfx = "_ms" if timer == "profiler" else "_event_ms"
    bounds = {out[f"{k}x{n}"]["bound_by"] for k, n in LAYER_PROJ}
    out["layer"] = {
        "kernel_ms": min(layer("kernel" + sfx), layer("kernel_again" + sfx)),
        "plain_ms": min(layer("plain" + sfx), layer("plain_again" + sfx)),
        "library_ms": layer("library" + sfx),
        "bound_ms": layer("bound_ms"), "int8_ops": layer("ops"),
        "bound_by": "operations" if bounds == {"operations"} else "bytes",
        "tops": layer("ops") / (min(layer("kernel" + sfx),
                                         layer("kernel_again" + sfx))
                                     * 1e-3) / 1e12}
    return {"phase": "qmatmul_prefill_timing", "m": m, "timer": timer,
            **out}


def phase_qmatmul_regimes(device) -> dict:
    """Both W8A8 regimes on one phi4 layer's 7 projections at m around
    the threshold (``TC_MIN_M``, which the planner reads at each call, is
    moved for the run): device time per layer of each, the evidence for
    where the threshold sits."""
    from repro_torch.kernels import w8a8_matmul as W8
    saved = W8.TC_MIN_M
    out = {"tc_min_m": saved}
    try:
        for m in REGIME_M:
            ops_ = {kn: _qmm_operands(m, kn[0], kn[1], False, 11, device)
                    for kn in LAYER_PROJ}
            row = {}
            for regime, threshold in (("dp4a", 10 ** 9), ("tc", 1)):
                W8.TC_MIN_M = threshold
                total = 0.0
                for kn, c in LAYER_PROJ.items():
                    prof, event = _device_ms(
                        lambda i, o=ops_[kn]: W8.w8a8_matmul(*o), 50)
                    total += c * (event if prof is None else prof)
                row[regime] = total
            out[str(m)] = row
    finally:
        W8.TC_MIN_M = saved
    faster = [m for m in REGIME_M if out[str(m)]["tc"] < out[str(m)]["dp4a"]]
    out["tc_faster_at"] = faster
    return {"phase": "qmatmul_regimes", **out}


# ---------------------------------------------- int8 KV, batching, prefill

def _reset_attention_counts() -> None:
    from repro_torch.kernels import flash_attention, w8a8_decode
    flash_attention.launches = w8a8_decode.launches = 0
    flash_attention.launches_tc = flash_attention.launches_f32 = 0
    flash_attention.launches_windowed = 0
    w8a8_decode.kernel_launches = 0


def _attention_counts() -> dict:
    from repro_torch.kernels import flash_attention, w8a8_decode
    return {"w8a8_decode_attention": w8a8_decode.launches,
            "w8a8_decode_attention_kernels": w8a8_decode.kernel_launches,
            "flash_attention": flash_attention.launches,
            "flash_attention_tc": flash_attention.launches_tc,
            "flash_attention_f32": flash_attention.launches_f32,
            "flash_attention_windowed": flash_attention.launches_windowed}


def _requests(vocab: int):
    import numpy as np
    from repro_torch.serving.scheduler import Request
    rng = np.random.default_rng(BATCHER["seed"])
    reqs = []
    for i in range(BATCHER["n_requests"]):
        n = int(rng.integers(BATCHER["prompt"][0], BATCHER["prompt"][1] + 1))
        g = int(rng.integers(BATCHER["new"][0], BATCHER["new"][1] + 1))
        reqs.append(Request(rid=i, prompt=[int(t) for t in
                                           rng.integers(0, vocab, n)],
                            max_new=g))
    return reqs


def phase_batcher(device, model, params,
                  name: str = "serve_batcher_int8kv") -> dict:
    """Continuous batching over the int8 KV cache at full width."""
    import torch
    from repro_torch.serving.scheduler import ContinuousBatcher
    cfg = model.cfg
    torch.cuda.reset_peak_memory_stats(device)
    bat = ContinuousBatcher(model, params, n_slots=BATCHER["n_slots"],
                            max_seq=BATCHER["max_seq"], kv_quant=True)
    cache_bytes = {k: v.numel() * v.element_size()
                   for k, v in bat.caches.items()}
    reqs = _requests(cfg.vocab)
    for r in reqs:
        bat.submit(r)
    _reset_attention_counts()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    done = bat.run()
    torch.cuda.synchronize(device)
    wall_s = time.perf_counter() - t0
    launches = _attention_counts()
    peak = torch.cuda.max_memory_allocated(device)
    check(len(done) == len(reqs) and all(r.done for r in done),
          f"{len(done)} of {len(reqs)} requests completed")
    for r in done:
        want = r.submit_iter + len(r.prompt) + r.max_new - 1
        check(r.complete_iter == want,
              f"request {r.rid} completed at {r.complete_iter}, not {want}")
        check(len(r.generated) == r.max_new, f"request {r.rid} length")
        check(all(0 <= t < cfg.vocab for t in r.generated),
              f"request {r.rid}: token outside [0, vocab)")
    # run() stops when nothing is queued or in flight, so every
    # iteration it ran took a decode step
    steps = bat.it
    want = steps * cfg.n_layers
    check(launches["w8a8_decode_attention"] == want,
          f"decode attention launched {launches['w8a8_decode_attention']} "
          f"times, expected {want}")
    check(launches["w8a8_decode_attention_kernels"]
          == DECODE_LAUNCHES_PER_CALL * want,
          f"decode attention's calls launched "
          f"{launches['w8a8_decode_attention_kernels']} kernels, expected "
          f"{DECODE_LAUNCHES_PER_CALL} a call")
    check(launches["flash_attention"] == 0, "flash attention launched in "
                                            "the batcher")
    generated = sum(r.max_new for r in done)

    # one iteration at per-slot positions, wall time vs device busy time
    tok = torch.tensor([[r.prompt[0]] for r in reqs[:bat.n]],
                       device=device)
    pos = torch.tensor([40, 300, 1000, 4000], dtype=torch.int32,
                       device=device)

    def step(_):
        model.decode_step(params, bat.caches, tok, pos)
    step(0)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    step(0)
    torch.cuda.synchronize(device)
    step_wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, top, ops, _ = _profile_device_ms(step, BUSY_STEPS)
    return {"phase": name, "launches": launches,
            "iterations": steps,
            "requests": [[r.rid, len(r.prompt), r.max_new, r.submit_iter,
                          r.complete_iter] for r in reqs],
            "wall_s": wall_s, "ms_per_iteration": wall_s / steps * 1e3,
            "generated_tokens": generated,
            "tok_per_s": generated / wall_s,
            "tok_per_s_with_prompt_tokens":
                sum(len(r.prompt) + r.max_new - 1 for r in done) / wall_s,
            "cache_bytes": cache_bytes, "peak_mem_bytes": peak,
            "step_wall_ms": step_wall_ms, "step_device_ms": busy_ms,
            "device_busy_share": (busy_ms / step_wall_ms
                                  if busy_ms else None),
            "step_device_ops": ops, "step_top_kernels_ms": top}


def phase_batcher_parity(device, params) -> dict:
    """Kernel route vs plain route over int8 caches, teacher-forced at
    per-slot positions that differ across slots."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    cfg = get_config(SERVE_ARCH)
    kern = Model(cfg, device=device, impl="kernel")
    plain = Model(cfg, device=device, impl="ref")
    b = len(PARITY_OFFSETS)
    ck = kern.init_cache(b, BATCHER["max_seq"], kv_quant=True)
    cp = plain.init_cache(b, BATCHER["max_seq"], kv_quant=True)
    offs = torch.tensor(PARITY_OFFSETS, dtype=torch.int32, device=device)
    tokens = torch.randint(0, cfg.vocab, (b, PARITY_STEPS), device=device,
                           generator=torch.Generator(device).manual_seed(2))
    worst_abs, worst_scaled, agree = 0.0, 0.0, []
    _reset_attention_counts()
    for i in range(PARITY_STEPS):
        tok = tokens[:, i:i + 1]
        lk, ck = kern.decode_step(params, ck, tok, offs + i)
        lp, cp = plain.decode_step(params, cp, tok, offs + i)
        check(bool(torch.isfinite(lk).all()), "non-finite logits")
        diff = float((lk.float() - lp.float()).abs().max())
        worst_abs = max(worst_abs, diff)
        worst_scaled = max(worst_scaled,
                           diff / max(float(lp.float().abs().max()), 1e-30))
        agree.append(float((lk.argmax(-1) == lp.argmax(-1)).float().mean()))
    launches = _attention_counts()
    check(launches["w8a8_decode_attention"] == PARITY_STEPS * cfg.n_layers,
          "decode attention launches in the parity run")
    check(worst_abs <= LOGIT_TOL,
          f"int8-KV logits kernel vs plain {worst_abs:.3g} > {LOGIT_TOL}")
    same = {name: bool(torch.equal(ck[name], cp[name])) for name in ck}
    check(all(same.values()), f"int8 caches differ between routes: {same}")
    return {"phase": "serve_batcher_parity_int8kv", "steps": PARITY_STEPS,
            "offsets": list(PARITY_OFFSETS), "logits_max_abs": worst_abs,
            "logits_rel_to_max": worst_scaled,
            "greedy_agreement_per_step": agree, "caches_identical": same}


class _recording_blocks:
    """Records every dense block's output of the forwards run inside it."""

    def __enter__(self):
        from repro_torch.models import model
        self.real, self.outputs = model._dense_block, []

        def block(*args, **kwargs):
            out = self.real(*args, **kwargs)
            self.outputs.append(out)
            return out
        model._dense_block = block
        return self.outputs

    def __exit__(self, *exc):
        from repro_torch.models import model
        model._dense_block = self.real
        return False


def phase_prefill(device, params) -> dict:
    """``Model.prefill`` at 4 x 16 and the forward at 1 x 4096, kernel
    route vs plain route."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import attention
    from repro_torch.models.model import Model
    cfg = get_config(SERVE_ARCH)
    kern = Model(cfg, device=device)
    plain = Model(cfg, device=device, impl="ref")
    g = torch.Generator(device).manual_seed(3)
    prompts = torch.randint(0, cfg.vocab, (PREFILL["batch"],
                                           PREFILL["prompt_len"]),
                            device=device, generator=g)
    _reset_attention_counts()
    _reset_matmul_counts()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    logits, caches = kern.prefill(params, prompts)
    torch.cuda.synchronize(device)
    prefill_s = time.perf_counter() - t0
    n = _attention_counts()["flash_attention_tc"]
    check(n == cfg.n_layers, f"prefill launched bf16 flash {n} times")
    prefill_mm = _matmul_counts()
    # the forward's projections at m = 4 x 16 on the tensor cores, the 16
    # replayed decode steps' at m = 4 on the split-k regime
    check(prefill_mm["w8a8_matmul_tc"] == 7 * cfg.n_layers
          and prefill_mm["w8a8_matmul_dp4a"]
          == 7 * cfg.n_layers * PREFILL["prompt_len"],
          f"prefill W8A8 regimes: {prefill_mm}")
    check(tuple(logits.shape) == (PREFILL["batch"], PREFILL["prompt_len"],
                                  cfg.vocab), "prefill logits shape")
    check(bool(torch.isfinite(logits).all()), "non-finite prefill logits")
    check(caches["k"].dtype == torch.bfloat16, "prefill cache dtype")
    del logits, caches

    tokens = torch.randint(0, cfg.vocab, (1, PREFILL["long_len"]),
                           device=device, generator=g)
    fwd, hidden = {}, {}
    for name, model in (("kernel", kern), ("plain", plain)):
        with _recording_blocks() as hidden[name]:      # the warm-up run
            model.forward(params, tokens, last_only=True)
        _reset_attention_counts()
        _reset_matmul_counts()
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        out, _ = model.forward(params, tokens, last_only=True)
        torch.cuda.synchronize(device)
        fwd[name] = {"logits": out,
                     "wall_s": time.perf_counter() - t0,
                     "flash_launches": _attention_counts(),
                     "matmul_launches": _matmul_counts()}
    flash_n = fwd["kernel"]["flash_launches"]
    check(flash_n["flash_attention"] == cfg.n_layers
          and flash_n["flash_attention_tc"] == cfg.n_layers,
          f"forward's flash launches {flash_n}: all {cfg.n_layers} on the "
          f"tensor-core route expected")
    mm_n = fwd["kernel"]["matmul_launches"]
    check(mm_n["w8a8_matmul_tc"] == 7 * cfg.n_layers
          and mm_n["w8a8_matmul_dp4a"] == 0,
          f"forward's W8A8 launches {mm_n}: {7 * cfg.n_layers} on the "
          f"tensor cores expected")
    check(fwd["plain"]["flash_launches"]["flash_attention"] == 0
          and fwd["plain"]["matmul_launches"]["w8a8_matmul"] == 0,
          "plain route launched a kernel")
    lk, lp = fwd["kernel"]["logits"], fwd["plain"]["logits"]
    check(tuple(lk.shape) == (1, 1, cfg.vocab), "forward logits shape")
    check(bool(torch.isfinite(lk).all()), "non-finite forward logits")
    diff = float((lk.float() - lp.float()).abs().max())
    # per layer, the largest hidden-state difference over the largest value
    drift = [float((a.float() - b.float()).abs().max()
                   / b.float().abs().max())
             for a, b in zip(hidden["kernel"], hidden["plain"])]
    del hidden
    # The routes differ only in attention's float order; the W8A8 network's
    # per-tensor int8 activations amplify a one-ulp difference layer by
    # layer, so their logits are not held to the bf16 bound.  Instead: the
    # flash kernel against the plain route's attention on every layer's own
    # q, k, v, and the kernel route with that attention swapped in must
    # equal the plain route bit for bit.
    layers = []

    def swapped(q, k, v, *, causal=True, window=None, impl="auto"):
        got = real_attend(q, k, v, causal=causal, window=window, impl=impl)
        want = real_attend(q, k, v, causal=causal, window=window,
                           impl="ref")
        layers.append([flash_row_err(got, want), int((got != want).sum())])
        return want
    real_attend = attention.attend
    attention.attend = swapped
    try:
        mixed, _ = kern.forward(params, tokens, last_only=True)
    finally:
        attention.attend = real_attend
    check(len(layers) == cfg.n_layers, "swapped attention calls")
    worst_layer = max(e["max_abs"] for e, _ in layers)
    worst_row = max(e["row_rel"] for e, _ in layers)
    check(worst_layer <= FLASH_TOL["bfloat16"]
          and worst_row <= FLASH_ROW_RTOL,
          f"flash vs plain attention {worst_layer:.3g} absolute, "
          f"{worst_row:.3g} of a row's max on a layer of the "
          f"1 x {PREFILL['long_len']} forward")
    check(bool(torch.equal(mixed, lp)),
          "kernel route with plain attention differs from the plain route")
    n_out = tokens.shape[1] * cfg.n_heads * cfg.head_dim

    prof = _profile_split(
        lambda: kern.forward(params, tokens, last_only=True),
        {"flash": ("flash_tc_kernel",),
         "w8a8": ("w8a8_tc_kernel", "w8a8_dp4a_kernel")})
    total_ms, flash_ms = prof["profiled_device_ms"], prof["flash_device_ms"]
    w8a8_ms = prof["w8a8_device_ms"]
    return {"phase": "prefill", "prefill_batch": PREFILL["batch"],
            "prefill_len": PREFILL["prompt_len"], "prefill_s": prefill_s,
            "forward_len": PREFILL["long_len"],
            "forward_wall_s": fwd["kernel"]["wall_s"],
            "forward_plain_wall_s": fwd["plain"]["wall_s"],
            "flash_launches_per_forward": flash_n["flash_attention_tc"],
            "forward_launches": {**flash_n, **mm_n},
            "prefill_matmul_launches": prefill_mm,
            "logits_max_abs_vs_plain": diff,
            "logits_max_abs": float(lp.float().abs().max()),
            "hidden_drift_per_layer": drift,
            "flash_vs_plain_per_layer_max_abs": [e["max_abs"]
                                                 for e, _ in layers],
            "flash_vs_plain_per_layer_row_rel": [e["row_rel"]
                                                 for e, _ in layers],
            "attention_out_per_layer_median_abs": [e["median_abs_want"]
                                                   for e, _ in layers],
            "flash_vs_plain_ulp_flip_share": max(n for _, n in layers)
            / n_out,
            "kernel_matmuls_plain_attention_equal_plain_route": True,
            "greedy_token_same": bool(torch.equal(lk.argmax(-1),
                                                  lp.argmax(-1))),
            "profiled_wall_ms": prof["profiled_wall_ms"],
            "profiled_device_ms": total_ms or None,
            "flash_device_ms": flash_ms or None,
            "flash_share_of_device": flash_ms / total_ms if total_ms
            else None,
            "w8a8_device_ms": w8a8_ms or None,
            "w8a8_share_of_device": w8a8_ms / total_ms if total_ms
            else None,
            "profiled_kernel_names": prof["kernel_names"],
            "flash_share_of_wall": (flash_ms / prof["profiled_wall_ms"]
                                    if flash_ms else None)}


def phase_prefill_fp32(device) -> dict:
    """The FP32 PE mode's forward, which takes the float32 flash route:
    phi4-mini at full width, depth cut to ``FP32_LAYERS``, 1 x 4096
    tokens through ``Model.forward``.  Every layer's flash launch is on
    the float32 route, the logits are finite, and on each layer's own
    q, k, v the kernel stays within the float32 bound of the plain
    attention."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import attention
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(get_config(SERVE_ARCH), quant="fp32",
                              n_layers=FP32_LAYERS)
    model = Model(cfg, device=device)
    params = model.init(torch.Generator(device).manual_seed(4))
    tokens = torch.randint(0, cfg.vocab, (1, PREFILL["long_len"]),
                           device=device,
                           generator=torch.Generator(device).manual_seed(5))
    model.forward(params, tokens, last_only=True)           # warm-up
    _reset_attention_counts()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    logits, _ = model.forward(params, tokens, last_only=True)
    torch.cuda.synchronize(device)
    wall_s = time.perf_counter() - t0
    launches = _attention_counts()
    check(launches["flash_attention_f32"] == cfg.n_layers
          and launches["flash_attention_tc"] == 0,
          f"FP32 forward's flash launches {launches}")
    check(logits.dtype == torch.float32
          and tuple(logits.shape) == (1, 1, cfg.vocab)
          and bool(torch.isfinite(logits).all()), "FP32 forward logits")
    layers = []
    real_attend = attention.attend

    def swapped(q, k, v, *, causal=True, window=None, impl="auto"):
        got = real_attend(q, k, v, causal=causal, window=window, impl=impl)
        want = real_attend(q, k, v, causal=causal, window=window,
                           impl="ref")
        layers.append(float((got - want).abs().max()))
        return got
    attention.attend = swapped
    try:
        model.forward(params, tokens, last_only=True)
    finally:
        attention.attend = real_attend
    check(max(layers) <= FLASH_TOL["float32"],
          f"float32 flash vs plain attention {max(layers):.3g} on a layer")
    del model, params
    return {"phase": "prefill_fp32", "n_layers": cfg.n_layers,
            "forward_len": PREFILL["long_len"], "forward_wall_s": wall_s,
            "launches": launches,
            "flash_vs_plain_per_layer_max_abs": layers}


# ------------------------------------------ SSM and hybrid (mamba2, zamba2)

def _arch_model(arch: str, device, impl: str = "auto", quant=None,
                quantize: bool = True, n_layers=None):
    """``arch`` at full width and depth (or ``n_layers``) with random
    weights from ``SERVE["seed"]`` drawn as ``serve`` draws them
    (quantized unless ``quantize`` is false; ``quant`` overrides the
    config's mode)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    cfg = get_config(arch)
    if quant is not None:
        cfg = dataclasses.replace(cfg, quant=quant)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    model = Model(cfg, device=device, impl=impl)
    params = model.init(torch.Generator(device).manual_seed(SERVE["seed"]),
                        quantize=quantize)
    return model, params


def _matmuls_per_pass(cfg) -> tuple[int, int]:
    """W8A8 products a decode step or forward makes (7 a dense layer; 4
    an MoE layer, its attention's: the experts are bf16 products; in an
    SSM or hybrid, in_proj and out_proj a layer and 7 an application of
    the shared block), and the shared block's applications."""
    if cfg.family == "dense":
        return 7 * cfg.n_layers, 0
    if cfg.family == "moe":
        return 4 * cfg.n_layers, 0
    apps = sum(1 for l in range(cfg.n_layers) if cfg.shared_attn_every
               and l % cfg.shared_attn_every == cfg.shared_attn_every - 1)
    return 2 * cfg.n_layers + 7 * apps, apps


def phase_arch_serve(device, arch: str, name: str, built=None) -> dict:
    """``launch.serve.generate`` at full width in W8A8 for the SSM
    (mamba2-130m), hybrid (zamba2-1.2b), windowed dense (gemma3-4b, bf16
    KV: ring buffers on its local layers) or MoE (moonshot, phi3.5-moe)
    family, every W8A8 product on the split-k regime and no other kernel;
    then the served 16 tokens teacher-forced through the kernel and plain
    routes on the same params (logits and every cache bit for bit after
    each step; for MoE also the assignments dropped past an expert's
    capacity, counted on the kernel route) and one profiled decode step.
    ``built``: a kernel-route model and its params, drawn by the caller
    (else drawn here by ``_arch_model``).  The served stream is returned
    under ``stream`` (a tensor: pop it before printing)."""
    import torch
    from repro_torch.launch.serve import generate
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.model import EXPERT_NAMES, Model
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    kern, params = built or _arch_model(arch, device, impl="kernel")
    cfg = kern.cfg
    prompts = torch.randint(
        0, cfg.vocab, (SERVE["batch"], SERVE["prompt_len"]), device=device,
        generator=torch.Generator(device).manual_seed(SERVE["seed"] + 1))
    _reset_matmul_counts()
    _reset_attention_counts()
    res = generate(kern, params, prompts, gen=SERVE["gen"])
    wall_s = time.perf_counter() - t0
    launches = {**_matmul_counts(), **_attention_counts()}
    peak = torch.cuda.max_memory_allocated(device)
    steps = SERVE["prompt_len"] + SERVE["gen"]
    per_pass, apps = _matmuls_per_pass(cfg)
    want = steps * per_pass
    check(launches["w8a8_matmul"] == want
          and launches["w8a8_matmul_dp4a"] == want
          and launches["w8a8_matmul_tc"] == 0,
          f"{arch} serve: W8A8 launches {launches}, expected {want} on "
          f"the split-k regime")
    check(launches["w4a8_matmul"] == 0 and launches["flash_attention"] == 0
          and launches["w8a8_decode_attention"] == 0,
          f"{arch} serve launched another kernel: {launches}")
    toks = res["tokens"]
    check(tuple(toks.shape) == (SERVE["batch"], SERVE["gen"])
          and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab,
          f"{arch} tokens {tuple(toks.shape)} outside [0, vocab)")

    # the served stream (the prompts, then the greedy tokens) through both
    # routes on the same params
    stream = torch.cat([prompts, toks.to(prompts.dtype)], dim=1)
    plain = Model(cfg, device=device, impl="ref")
    ck = kern.init_cache(SERVE["batch"], steps + 1)
    cp = plain.init_cache(SERVE["batch"], steps + 1)
    worst_abs = worst_scaled = 0.0
    logits_same = caches_same = True
    dropped = []            # per kernel-route step: (~keep).sum() a layer
    real_dispatch = moe_mod.dispatch

    def counting(experts, n_experts, cap):
        out = real_dispatch(experts, n_experts, cap)
        dropped[-1].append((~out[2]).sum())
        return out
    _reset_matmul_counts()
    for i in range(steps):
        tok = stream[:, i:i + 1]
        dropped.append([])
        moe_mod.dispatch = counting
        try:
            lk, ck = kern.decode_step(params, ck, tok, i)
        finally:
            moe_mod.dispatch = real_dispatch
        lp, cp = plain.decode_step(params, cp, tok, i)
        check(bool(torch.isfinite(lk).all()), f"{arch}: non-finite logits")
        diff = float((lk.float() - lp.float()).abs().max())
        worst_abs = max(worst_abs, diff)
        worst_scaled = max(worst_scaled,
                           diff / max(float(lp.float().abs().max()), 1e-30))
        logits_same &= bool(torch.equal(lk, lp))
        caches_same &= all(torch.equal(ck[k], cp[k]) for k in ck)
    parity_launches = _matmul_counts()
    check(parity_launches["w8a8_matmul"] == want,
          f"{arch} parity run: kernel route launched {parity_launches}")
    check(logits_same, f"{arch} logits kernel vs plain "
                       f"{worst_scaled:.3g} x max|logit|, not bit for bit")
    check(caches_same, f"{arch} caches {sorted(ck)} differ between the "
                       f"routes")
    tok = stream[:, -1:]

    def step(_):
        kern.decode_step(params, ck, tok, steps)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    step(0)
    torch.cuda.synchronize(device)
    step_wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, top, ops, _ = _profile_device_ms(step, BUSY_STEPS)
    # bytes a step must read: the quantized projections and their scales,
    # and the float32 embedding the logits product reads; an MoE layer's
    # router and every expert (the (E, C, d) buffer's products read all E)
    proj = sum(v.data.numel() + 4 * v.scale.numel()
               for lp in params["layers"] + [params.get("shared", {})]
               for v in lp.values() if hasattr(v, "scale"))
    moe_bytes = sum(lp[k].numel() * lp[k].element_size()
                    for lp in params["layers"]
                    for k in ("router",) + EXPERT_NAMES if k in lp)
    step_bytes = proj + moe_bytes + params["embed"].numel() * 4
    cache_keys = sorted(ck)
    moe = {}
    if cfg.family == "moe":
        per_step = [int(torch.stack(d).sum()) for d in dropped]
        entries = SERVE["batch"] * cfg.top_k * cfg.n_layers
        moe = {"capacity": moe_mod.capacity(SERVE["batch"], cfg.n_experts,
                                            cfg.top_k, 1.25),
               "dropped_per_step": per_step,
               "assignments_per_step": entries,
               "dropped_share": sum(per_step) / (entries * steps),
               "expert_and_router_bytes": moe_bytes,
               "tf32_matmul_allowed":
                   torch.backends.cuda.matmul.allow_tf32}
        check(not torch.backends.cuda.matmul.allow_tf32,
              f"{arch}: TF32 matmuls are enabled; the router must stay "
              f"float32")
    del kern, plain, params, ck, cp
    return {"phase": name, "arch": arch, **moe, "stream": stream,
            "n_layers": cfg.n_layers, "shared_applications": apps,
            "launches": launches,
            "w8a8_per_step": per_pass,
            "prefill_s": res["prefill_s"], "decode_s": res["decode_s"],
            "decode_step_ms": res["decode_s"] / SERVE["gen"] * 1e3,
            "tok_per_s": res["tok_per_s"], "wall_s_with_init": wall_s,
            "peak_mem_bytes": peak,
            "tokens_head": toks[0, :8].tolist(),
            "parity_steps": steps, "logits_max_abs": worst_abs,
            "logits_rel_to_max": worst_scaled,
            "logits_identical": logits_same,
            "caches_identical": caches_same, "cache_keys": cache_keys,
            "step_wall_ms": step_wall_ms, "step_device_ms": busy_ms,
            "device_busy_share": (busy_ms / step_wall_ms
                                  if busy_ms else None),
            "step_device_ops": ops, "step_top_kernels_ms": top,
            "step_bytes": step_bytes,
            "step_bound_ms": step_bytes / H100.hbm_bw * 1e3}


def _profile_split(fn, names: dict) -> dict:
    """One profiled call of ``fn``: device time in ms of the kernels
    whose names hold each of ``names``' substrings (and those names), the
    rest, and the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    split = {k: 0.0 for k in names}
    rows, total, matched = [], 0.0, set()
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if not us:
            continue
        total += us
        rows.append((us, ev.key[:60], ev.count))
        for k, subs in names.items():
            if any(s in ev.key for s in subs):
                split[k] += us
                matched.add(ev.key[:80])
                break
    out = {f"{k}_device_ms": v / 1e3 for k, v in split.items()}
    out.update(profiled_wall_ms=wall_ms, profiled_device_ms=total / 1e3,
               eager_device_ms=(total - sum(split.values())) / 1e3,
               kernel_names=sorted(matched),
               top_kernels_ms=[[key, us / 1e3, n] for us, key, n in
                               sorted(rows, reverse=True)[:8]])
    return out


def phase_ssm_prefill(device) -> dict:
    """The 1 x 4096 forward of mamba2-130m and zamba2-1.2b at full width
    in W8A8: wall time, peak memory, launches (every projection on the
    tensor cores, flash once per application of zamba2's shared block),
    the device time split (W8A8 ``tc``, flash, the rest: the SSD's and
    the other eager ops), the SSD's own time; kernel route vs plain
    route (mamba2: bit for bit; zamba2: flash within 2e-2 of the plain
    attention on each application's own q, k, v and each output row
    within 2^-6 of its own max|value|, and the kernel route
    with that attention swapped in equal to the plain route bit for
    bit)."""
    import torch
    from repro_torch.models import attention, ssm
    from repro_torch.models.model import Model
    out = {"phase": "ssm_prefill", "forward_len": PREFILL["long_len"]}
    for family, arch in SSM_ARCHS.items():
        kern, params = _arch_model(arch, device)
        cfg = kern.cfg
        plain = Model(cfg, device=device, impl="ref")
        tokens = torch.randint(
            0, cfg.vocab, (1, PREFILL["long_len"]), device=device,
            generator=torch.Generator(device).manual_seed(3))
        per_pass, apps = _matmuls_per_pass(cfg)
        fwd = {}
        for name, model in (("kernel", kern), ("plain", plain)):
            model.forward(params, tokens, last_only=True)       # warm-up
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
            base = torch.cuda.memory_allocated(device)
            _reset_matmul_counts()
            _reset_attention_counts()
            t0 = time.perf_counter()
            logits, _ = model.forward(params, tokens, last_only=True)
            torch.cuda.synchronize(device)
            fwd[name] = {"logits": logits,
                         "wall_s": time.perf_counter() - t0,
                         "peak_over_params_bytes":
                             torch.cuda.max_memory_allocated(device) - base,
                         "launches": {**_matmul_counts(),
                                      **_attention_counts()}}
        n = fwd["kernel"]["launches"]
        check(n["w8a8_matmul_tc"] == per_pass and n["w8a8_matmul_dp4a"] == 0
              and n["flash_attention_tc"] == apps
              and n["flash_attention"] == apps,
              f"{arch} forward's launches {n}: {per_pass} W8A8 on the "
              f"tensor cores and {apps} bf16 flash expected")
        check(fwd["plain"]["launches"]["w8a8_matmul"] == 0
              and fwd["plain"]["launches"]["flash_attention"] == 0,
              f"{arch}: the plain route launched a kernel")
        lk, lp = fwd["kernel"]["logits"], fwd["plain"]["logits"]
        check(tuple(lk.shape) == (1, 1, cfg.vocab)
              and bool(torch.isfinite(lk).all()),
              f"{arch} forward logits {tuple(lk.shape)}")
        row = {"arch": arch, "n_layers": cfg.n_layers,
               "shared_applications": apps,
               "forward_wall_s": fwd["kernel"]["wall_s"],
               "forward_plain_wall_s": fwd["plain"]["wall_s"],
               "peak_mem_over_params_bytes":
                   fwd["kernel"]["peak_over_params_bytes"],
               "launches": n,
               "logits_max_abs_vs_plain": float(
                   (lk.float() - lp.float()).abs().max()),
               "logits_max_abs": float(lp.float().abs().max())}
        if apps == 0:
            check(bool(torch.equal(lk, lp)),
                  f"{arch}: kernel route differs from the plain route")
            row["kernel_route_equals_plain"] = True
        else:
            apps_err = []

            def swapped(q, k, v, *, causal=True, window=None, impl="auto"):
                got = real_attend(q, k, v, causal=causal, window=window,
                                  impl=impl)
                want = real_attend(q, k, v, causal=causal,
                                   window=window, impl="ref")
                apps_err.append(flash_row_err(got, want))
                return want
            real_attend = attention.attend
            attention.attend = swapped
            try:
                mixed, _ = kern.forward(params, tokens, last_only=True)
            finally:
                attention.attend = real_attend
            check(len(apps_err) == apps, f"{arch}: swapped attention calls")
            worst = max(e["max_abs"] for e in apps_err)
            worst_row = max(e["row_rel"] for e in apps_err)
            check(worst <= FLASH_TOL["bfloat16"]
                  and worst_row <= FLASH_ROW_RTOL,
                  f"{arch}: flash vs plain attention {worst:.3g} absolute, "
                  f"{worst_row:.3g} of a row's max on an application of "
                  f"the shared block")
            check(bool(torch.equal(mixed, lp)),
                  f"{arch}: kernel route with plain attention differs from "
                  f"the plain route")
            row.update(flash_vs_plain_per_application_max_abs=[
                           e["max_abs"] for e in apps_err],
                       flash_vs_plain_per_application_row_rel=[
                           e["row_rel"] for e in apps_err],
                       attention_out_per_application_median_abs=[
                           e["median_abs_want"] for e in apps_err],
                       kernel_matmuls_plain_attention_equal_plain_route=True)
        # the SSD alone at this forward's shapes (one layer's inputs)
        seen = []
        real_ssd = ssm.ssd_chunked

        def record(*args, **kwargs):
            if not seen:
                seen.append((args, kwargs))
            return real_ssd(*args, **kwargs)
        ssm.ssd_chunked = record
        try:
            kern.forward(params, tokens, last_only=True)
        finally:
            ssm.ssd_chunked = real_ssd
        args, kwargs = seen[0]
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        ssd_ms, ssd_event_ms = _device_ms(
            lambda i: real_ssd(*args, **kwargs), 5, windows=3)
        row.update(ssd_chunk=kwargs["chunk"],
                   ssd_layer_device_ms=ssd_ms,
                   ssd_layer_event_ms=ssd_event_ms,
                   ssd_peak_over_inputs_bytes=
                       torch.cuda.max_memory_allocated(device) - base)
        del seen, args, kwargs
        row.update(_profile_split(
            lambda: kern.forward(params, tokens, last_only=True),
            {"w8a8_tc": ("w8a8_tc_kernel",),
             "flash": ("flash_tc_kernel",)}))
        out[family] = row
        del kern, plain, params, fwd, lk, lp
    return out


def phase_ssm_tc_shapes(device) -> dict:
    """W8A8's tensor-core regime at the 1 x 4096 forward's SSM projection
    shapes, mamba2's unaligned in_proj (n = 3352, 8 mod 16: the kernel's
    template without 16-byte copies) beside the aligned n = 3360: kernel
    (twice), plain version and ``torch._int_mm``, kernel equal to plain
    bit for bit, beside the bound of the int8 operations."""
    import torch
    from repro_torch.kernels import w8a8_matmul as W8
    m = PREFILL_M
    out = {"phase": "ssm_tc_shapes", "m": m}
    for k, n in SSM_TC_SHAPES:
        check(W8.plan(m, k, n).regime == "tc", f"{(m, k, n)} not on tc")
        x, w, xs, ws = _qmm_operands(m, k, n, False, k + n, device)
        got = W8.w8a8_matmul(x, w, xs, ws)
        check(bool(torch.equal(got, W8.w8a8_matmul_ref(x, w, xs, ws))),
              f"W8A8 tc at {(m, k, n)} differs from its plain version")
        wcol = w.t().contiguous().t()
        row = {"aligned": k % 16 == 0 and n % 16 == 0}
        for name, fn, iters in (
                ("plain", lambda i: W8.w8a8_matmul_ref(x, w, xs, ws), 3),
                ("kernel", lambda i: W8.w8a8_matmul(x, w, xs, ws), 20),
                ("kernel_again", lambda i: W8.w8a8_matmul(x, w, xs, ws), 20),
                ("library", lambda i: torch._int_mm(x, wcol), 20)):
            row[f"{name}_ms"], row[f"{name}_event_ms"] = _device_ms(fn,
                                                                    iters)
        bound = _bound(W8.cost(m, k, n))
        row.update(bound_ms=bound["bound_ms"], bound_by=bound["bound_by"])
        out[f"{k}x{n}"] = row
        del x, w, wcol, got
    return out


def phase_loss(device) -> dict:
    """``Model.loss`` of mamba2-130m at full width under the fp32 policy
    on ``SyntheticLM`` batch 0 (4 x 512), the same params on the card and
    on the CPU: the two within 1e-5 relative."""
    import torch
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.model import Model
    card, params = _arch_model(LOSS["arch"], device, quant=LOSS["quant"],
                              quantize=False)
    cfg = card.cfg
    t0 = time.perf_counter()
    data = SyntheticLM(DataConfig(cfg.vocab, LOSS["seq_len"],
                                  LOSS["batch"]))
    batch = data.batch(LOSS["step"], device=device)
    data_s = time.perf_counter() - t0
    card.loss(params, batch, train=False)                   # warm-up
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    got = card.loss(params, batch, train=False)
    torch.cuda.synchronize(device)
    card_s = time.perf_counter() - t0
    cpu = Model(cfg, device="cpu")
    cpu_params = {"embed": params["embed"].cpu(),
                  "final_norm": params["final_norm"].cpu(),
                  "layers": [{k: v.cpu() for k, v in lp.items()}
                             for lp in params["layers"]]}
    del params
    t0 = time.perf_counter()
    want = cpu.loss(cpu_params, {k: v.cpu() for k, v in batch.items()},
                    train=False)
    cpu_s = time.perf_counter() - t0
    rel = abs(float(got) - float(want)) / abs(float(want))
    check(math.isfinite(float(got)) and rel <= LOSS["rtol"],
          f"loss on the card {float(got)!r} vs the CPU {float(want)!r}: "
          f"{rel:.3g} relative")
    return {"phase": "loss", "arch": LOSS["arch"], "quant": LOSS["quant"],
            "batch": LOSS["batch"], "seq_len": LOSS["seq_len"],
            "card_loss": float(got), "cpu_loss": float(want),
            "rel_diff": rel, "card_s": card_s, "cpu_s": cpu_s,
            "synthetic_batch_s": data_s}


# ------------------------------------- the windowed dense family (gemma3)

def phase_window_ring(device, model, params) -> dict:
    """One local layer of gemma3 at full width on int8 ring buffers of
    1024 (b = 4, per-slot starts ``PARITY_OFFSETS``) stepped until every
    slot has passed ``RING["until"]``: at each step the attention output
    (the input of ``wo``) of the kernel route within ``DECODE_TOL`` x
    max|out| of the plain route's, and equal within the same bound to a
    full cache of ``RING["full_s"]`` read through the slice branch; the
    same with bf16 caches (within the bf16 bound of 2e-2 and each row
    within 2^-6 of its max); ring and slice equal before the first wrap;
    the kernel's and the plain route's rings bit for bit at the end.
    Then the decode kernel's time at this ring's shape and at the global
    layers' S = 4096."""
    import torch
    from repro_torch.models import attention
    from repro_torch.models.model import layer_windows
    cfg = model.cfg
    check(layer_windows(cfg)[0] == cfg.window, "layer 0 is not local")
    lp = params["layers"][0]
    W, b = cfg.window, len(PARITY_OFFSETS)
    kvh, hd = cfg.n_kv_heads, cfg.head_dim

    def caches(n, int8):
        dt = torch.int8 if int8 else torch.bfloat16
        kv = [torch.zeros((b, n, kvh, hd), dtype=dt, device=device)
              for _ in "kv"]
        sc = [torch.zeros((b, n, kvh), device=device) for _ in "kv"] \
            if int8 else None
        return kv, sc
    routes = {"ring_kernel": (caches(W, True), "kernel"),
              "ring_plain": (caches(W, True), "ref"),
              "slice_kernel": (caches(RING["full_s"], True), "kernel"),
              "ring_bf16": (caches(W, False), "kernel"),
              "slice_bf16": (caches(RING["full_s"], False), "kernel")}
    offs = torch.tensor(PARITY_OFFSETS, device=device)
    steps = RING["until"] + 1 - min(PARITY_OFFSETS)
    g = torch.Generator(device).manual_seed(5)
    cores = []
    real_qdot = attention.qdot

    def recording(t, w, *a, **k):
        if w is lp["wo"]:
            cores.append(t.float().reshape(b, cfg.n_heads, hd))
        return real_qdot(t, w, *a, **k)
    worst = {"kernel_vs_plain": 0.0, "ring_vs_slice_int8": 0.0,
             "ring_vs_slice_bf16": 0.0, "ring_vs_slice_bf16_row_rel": 0.0}
    equal_before_wrap = True
    _reset_attention_counts()
    attention.qdot = recording
    t0 = time.perf_counter()
    try:
        for i in range(steps):
            x = torch.randn((b, 1, cfg.d_model), generator=g,
                            device=device).to(torch.bfloat16)
            out = {}
            for name, ((kv, sc), impl) in routes.items():
                cores.clear()
                attention.decode_self_attention(
                    x, lp, cfg, *kv, offs + i, policy=model.policy,
                    static_window=W, kv_scales=sc, impl=impl)
                out[name] = cores[0]
            for key, a, ref in (("kernel_vs_plain", "ring_kernel",
                                 "ring_plain"),
                                ("ring_vs_slice_int8", "ring_kernel",
                                 "slice_kernel")):
                err = float((out[a] - out[ref]).abs().max())
                worst[key] = max(worst[key], err)
                check(err <= DECODE_TOL * float(out[ref].abs().max()),
                      f"window_ring {key} {err:.3g} at step {i}")
            e = flash_row_err(out["ring_bf16"], out["slice_bf16"])
            worst["ring_vs_slice_bf16"] = max(worst["ring_vs_slice_bf16"],
                                              e["max_abs"])
            worst["ring_vs_slice_bf16_row_rel"] = max(
                worst["ring_vs_slice_bf16_row_rel"], e["row_rel"])
            check(e["max_abs"] <= FLASH_TOL["bfloat16"]
                  and e["row_rel"] <= FLASH_ROW_RTOL,
                  f"window_ring bf16 ring vs slice {e} at step {i}")
            if i + max(PARITY_OFFSETS) < W:     # no ring has wrapped yet
                equal_before_wrap &= all(
                    torch.equal(out[f"ring_{k}"], out[f"slice_{k}"])
                    for k in ("kernel", "bf16"))
    finally:
        attention.qdot = real_qdot
    torch.cuda.synchronize(device)
    wall_s = time.perf_counter() - t0
    launches = _attention_counts()
    check(equal_before_wrap, "window_ring: ring and slice differ before "
                             "the wrap")
    check(launches["w8a8_decode_attention"] == 2 * steps,
          f"window_ring decode launches {launches}, expected {2 * steps}")
    (rk, rv), (rks, rvs) = routes["ring_kernel"][0]
    (pk, pv), (pks, pvs) = routes["ring_plain"][0]
    check(all(torch.equal(a, c) for a, c in ((rk, pk), (rv, pv),
                                              (rks, pks), (rvs, pvs))),
          "window_ring: the routes' int8 rings differ")
    del routes, cores
    shape = (b, kvh, cfg.n_heads // kvh, hd)
    timing = {str(S): _decode_timing(device, shape, S)
              for S in (W, BATCHER["max_seq"])}
    return {"phase": "window_ring", "steps": steps,
            "offsets": list(PARITY_OFFSETS),
            "last_positions": [o + steps - 1 for o in PARITY_OFFSETS],
            "ring": W, "full_s": RING["full_s"], "launches": launches,
            "worst": worst, "equal_before_wrap": equal_before_wrap,
            "routes_rings_identical": True, "wall_s": wall_s,
            "decode_timing": timing}


def phase_window_wrap(device) -> dict:
    """gemma3 at full width, depth cut to ``WRAP["n_layers"]`` (one period
    of its pattern: 5 local layers, 1 global), int8 KV, batch 2: decoded
    on the kernel route through position ``WRAP["until"]`` (every ring
    has wrapped), then from copies of those caches ``WRAP["steps"]`` more
    steps on each route: logits within ``LOGIT_TOL``, every cache bit for
    bit."""
    import torch
    from repro_torch.models.model import Model, layer_windows
    kern, params = _arch_model(WINDOW_ARCH, device, impl="kernel",
                               n_layers=WRAP["n_layers"])
    cfg = kern.cfg
    plain = Model(cfg, device=device, impl="ref")
    wins = layer_windows(cfg)
    check(wins.count(None) == 1 and wins.count(cfg.window) == 5,
          f"window_wrap layers {wins}")
    b, until = WRAP["batch"], WRAP["until"]
    caches = kern.init_cache(b, WRAP["max_seq"], kv_quant=True)
    check(caches["k_local"].shape[2] == cfg.window
          and caches["k"].shape[2] == WRAP["max_seq"],
          "window_wrap cache shapes")
    tokens = torch.randint(0, cfg.vocab, (b, until + 1 + WRAP["steps"]),
                           device=device,
                           generator=torch.Generator(device).manual_seed(6))
    _reset_attention_counts()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for i in range(until + 1):
        logits, caches = kern.decode_step(params, caches,
                                          tokens[:, i:i + 1], i)
    torch.cuda.synchronize(device)
    wrap_s = time.perf_counter() - t0
    launches = _attention_counts()
    check(bool(torch.isfinite(logits).all()), "window_wrap logits")
    check(launches["w8a8_decode_attention"] == (until + 1) * cfg.n_layers,
          f"window_wrap decode launches {launches}")
    ck = {k: v.clone() for k, v in caches.items()}
    cp = {k: v.clone() for k, v in caches.items()}
    del caches
    worst_abs, agree = 0.0, []
    for j in range(WRAP["steps"]):
        i = until + 1 + j
        tok = tokens[:, i:i + 1]
        lk, ck = kern.decode_step(params, ck, tok, i)
        lp, cp = plain.decode_step(params, cp, tok, i)
        check(bool(torch.isfinite(lk).all()), "non-finite logits")
        worst_abs = max(worst_abs, float((lk.float() - lp.float()).abs()
                                         .max()))
        agree.append(float((lk.argmax(-1) == lp.argmax(-1)).float().mean()))
    check(worst_abs <= LOGIT_TOL,
          f"window_wrap logits kernel vs plain {worst_abs:.3g} > "
          f"{LOGIT_TOL}")
    same = {k: bool(torch.equal(ck[k], cp[k])) for k in ck}
    check(all(same.values()), f"window_wrap caches differ: {same}")
    del kern, plain, params, ck, cp
    return {"phase": "window_wrap", "arch": WINDOW_ARCH,
            "depth_cut": f"{WRAP['n_layers']} of 34 layers (5 local, 1 "
                         "global: one period of the pattern)",
            "batch": b, "decoded_through": until, "wrap_s": wrap_s,
            "ms_per_step": wrap_s / (until + 1) * 1e3,
            "launches": launches, "parity_steps": WRAP["steps"],
            "logits_max_abs": worst_abs,
            "greedy_agreement_per_step": agree, "caches_identical": same}


def phase_window_prefill(device, model, params) -> dict:
    """gemma3's 1 x 4096 forward at full depth: 34 bf16 flash launches,
    29 with the window of 1024 and 5 without, and 7 W8A8 ``tc`` launches a
    layer; flash within 2e-2 of the plain route's attention (chunked above
    2048 tokens) on each layer's own q, k, v and each row within 2^-6 of
    its own max, the kernel route with that attention swapped in equal to
    the plain route bit for bit; wall time, peak memory, the kernels'
    shares of device time, and flash on a local and a global layer's q,
    k, v beside its plain version, SDPA and its bound."""
    import torch
    from repro_torch.models import attention
    from repro_torch.models.model import Model, layer_windows
    cfg = model.cfg
    plain = Model(cfg, device=device, impl="ref")
    wins = layer_windows(cfg)
    n_win = sum(w is not None for w in wins)
    tokens = torch.randint(0, cfg.vocab, (1, PREFILL["long_len"]),
                           device=device,
                           generator=torch.Generator(device).manual_seed(3))
    fwd = {}
    for name, m in (("kernel", model), ("plain", plain)):
        m.forward(params, tokens, last_only=True)           # warm-up
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        _reset_matmul_counts()
        _reset_attention_counts()
        t0 = time.perf_counter()
        logits, _ = m.forward(params, tokens, last_only=True)
        torch.cuda.synchronize(device)
        fwd[name] = {"logits": logits, "wall_s": time.perf_counter() - t0,
                     "peak_over_params_bytes":
                         torch.cuda.max_memory_allocated(device) - base,
                     "launches": {**_matmul_counts(),
                                  **_attention_counts()}}
    n = fwd["kernel"]["launches"]
    check(n["flash_attention_tc"] == cfg.n_layers
          and n["flash_attention"] == cfg.n_layers
          and n["flash_attention_windowed"] == n_win == 29,
          f"{WINDOW_ARCH} forward's flash launches {n}: {cfg.n_layers} on "
          f"the bf16 route, 29 windowed")
    check(n["w8a8_matmul_tc"] == 7 * cfg.n_layers
          and n["w8a8_matmul_dp4a"] == 0,
          f"{WINDOW_ARCH} forward's W8A8 launches {n}")
    check(fwd["plain"]["launches"]["flash_attention"] == 0
          and fwd["plain"]["launches"]["w8a8_matmul"] == 0,
          "plain route launched a kernel")
    lk, lp = fwd["kernel"]["logits"], fwd["plain"]["logits"]
    check(tuple(lk.shape) == (1, 1, cfg.vocab)
          and bool(torch.isfinite(lk).all()),
          f"{WINDOW_ARCH} forward logits {tuple(lk.shape)}")

    layers, kept = [], {}
    real_attend = attention.attend

    def swapped(q, k, v, *, causal=True, window=None, impl="auto"):
        got = real_attend(q, k, v, causal=causal, window=window, impl=impl)
        want = real_attend(q, k, v, causal=causal, window=window,
                           impl="ref")
        layers.append((window, flash_row_err(got, want)))
        key = "local" if window is not None else "global"
        if key not in kept:
            kept[key] = [t.transpose(1, 2).contiguous() for t in (q, k, v)]
        return want
    attention.attend = swapped
    try:
        mixed, _ = model.forward(params, tokens, last_only=True)
    finally:
        attention.attend = real_attend
    check([w for w, _ in layers] == wins, "swapped attention windows")
    worst = max(e["max_abs"] for _, e in layers)
    worst_row = max(e["row_rel"] for _, e in layers)
    check(worst <= FLASH_TOL["bfloat16"] and worst_row <= FLASH_ROW_RTOL,
          f"{WINDOW_ARCH}: flash vs plain attention {worst:.3g} absolute, "
          f"{worst_row:.3g} of a row's max on a layer")
    check(bool(torch.equal(mixed, lp)),
          f"{WINDOW_ARCH}: kernel route with plain attention differs from "
          f"the plain route")
    prof = _profile_split(
        lambda: model.forward(params, tokens, last_only=True),
        {"flash": ("flash_tc_kernel",), "w8a8": ("w8a8_tc_kernel",)})

    # flash on a local and a global layer's own q, k, v (b, h, s, d)
    flash = {key: _flash_timing(device, *kept[key], window=window)
             for key, window in (("local", cfg.window), ("global", None))}
    total_ms, flash_ms = prof["profiled_device_ms"], prof["flash_device_ms"]
    walls = {k: fwd[k]["wall_s"] for k in fwd}
    peak = fwd["kernel"]["peak_over_params_bytes"]
    del kept, plain, fwd, mixed
    return {"phase": "window_prefill", "arch": WINDOW_ARCH,
            "forward_len": PREFILL["long_len"],
            "forward_wall_s": walls["kernel"],
            "forward_plain_wall_s": walls["plain"],
            "peak_mem_over_params_bytes": peak, "launches": n,
            "logits_max_abs_vs_plain": float(
                (lk.float() - lp.float()).abs().max()),
            "logits_max_abs": float(lp.float().abs().max()),
            "flash_vs_plain_per_layer_max_abs": [e["max_abs"]
                                                 for _, e in layers],
            "flash_vs_plain_per_layer_row_rel": [e["row_rel"]
                                                 for _, e in layers],
            "attention_out_per_layer_median_abs": [e["median_abs_want"]
                                                   for _, e in layers],
            "kernel_matmuls_plain_attention_equal_plain_route": True,
            **prof,
            "flash_share_of_device": flash_ms / total_ms if total_ms
            else None,
            "w8a8_share_of_device": prof["w8a8_device_ms"] / total_ms
            if total_ms else None,
            "flash_timing": flash}


# ------------------------------------------------ the MoE family (moonshot)

def phase_moe_int8kv(device, name: str, model, params, stream) -> dict:
    """The served ``stream`` teacher-forced through ``decode_step`` on int8
    KV caches on the kernel and plain routes: the decode kernel called once
    a layer and step (MHA moonshot: rep 1; phi3.5-moe: rep 4), logits
    within ``LOGIT_TOL``, int8 caches and scales identical after every
    step; ms a kernel-route step.  Then the decode kernel at this model's
    shape (b 4, S ``DECODE_S[0]``), held to its plain version and timed."""
    import torch
    from repro_torch.models.model import Model
    cfg = model.cfg
    plain = Model(cfg, device=device, impl="ref")
    b, steps = stream.shape[0], stream.shape[1]
    ck = model.init_cache(b, steps + 1, kv_quant=True)
    cp = plain.init_cache(b, steps + 1, kv_quant=True)
    worst_abs, agree, kern_s = 0.0, [], 0.0
    caches_same = True
    _reset_attention_counts()
    _reset_matmul_counts()
    for i in range(steps):
        tok = stream[:, i:i + 1]
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        lk, ck = model.decode_step(params, ck, tok, i)
        torch.cuda.synchronize(device)
        kern_s += time.perf_counter() - t0
        lp, cp = plain.decode_step(params, cp, tok, i)
        check(bool(torch.isfinite(lk).all()), f"{name}: non-finite logits")
        worst_abs = max(worst_abs, float((lk.float() - lp.float()).abs()
                                         .max()))
        agree.append(float((lk.argmax(-1) == lp.argmax(-1)).float().mean()))
        caches_same &= all(torch.equal(ck[k], cp[k]) for k in ck)
    launches = {**_attention_counts(), **_matmul_counts()}
    check(launches["w8a8_decode_attention"] == steps * cfg.n_layers
          and launches["flash_attention"] == 0,
          f"{name}: decode launches {launches}, expected "
          f"{steps * cfg.n_layers}")
    check(launches["w8a8_matmul_dp4a"] == steps * 4 * cfg.n_layers,
          f"{name}: W8A8 launches {launches}")
    check(worst_abs <= LOGIT_TOL,
          f"{name}: int8-KV logits kernel vs plain {worst_abs:.3g} > "
          f"{LOGIT_TOL}")
    check(caches_same, f"{name}: int8 caches differ between the routes")
    shape = (b, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads,
             cfg.head_dim)
    del plain, ck, cp
    return {"phase": name, "arch": cfg.name, "n_layers": cfg.n_layers,
            "decode_shape": list(shape), "steps": steps,
            "launches": launches, "logits_max_abs": worst_abs,
            "greedy_agreement_per_step": agree,
            "caches_identical": caches_same,
            "kernel_step_ms": kern_s / steps * 1e3,
            "decode_timing": {str(DECODE_S[0]): _decode_timing(
                device, shape, DECODE_S[0])}}


def _flash_timing(device, q, k, v, window=None, causal=True) -> dict:
    """Flash on (b, h, s, d) ``q``, ``k``, ``v`` (bf16, or float32: the
    3xTF32 route), causal (with a sliding ``window`` where given) or not:
    the kernel (twice), its plain version (twice) and SDPA (``is_causal``,
    or the window as a bool mask), in turns, beside its bound; the
    kernel's distance to the plain version."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    b, h, sq, d = q.shape
    sk = k.shape[2]
    qi = torch.arange(sq, device=device)[:, None]
    ki = torch.arange(sk, device=device)[None, :]
    mask = (ki <= qi) & (ki > qi - window) if window else None
    kw = dict(window=window, causal=causal)
    row = {"shape": [b, h, sq, d], "keys": sk, "window": window,
           "causal": causal, "dtype": str(q.dtype)}
    for name, fn, iters in (
            ("plain", lambda i: FA.flash_attention_ref(q, k, v, **kw), 3),
            ("kernel", lambda i: FA.flash_attention(q, k, v, **kw), 10),
            ("kernel_again", lambda i: FA.flash_attention(q, k, v, **kw),
             10),
            ("plain_again", lambda i: FA.flash_attention_ref(q, k, v, **kw),
             3),
            ("library", lambda i: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, is_causal=causal and mask is None),
             10)):
        row[f"{name}_ms"], row[f"{name}_event_ms"] = _device_ms(fn, iters)
    _best_times(row)
    # float32: 3xTF32 on the tensor cores (the fp32_dot class)
    bound = _bound(FA.cost(b, h, sq, sk, d, causal=causal, window=window,
                           dtype=q.dtype))
    row.update(flops=bound.pop("ops"), **bound,
               kernel_max_abs_vs_plain=float(
                   (FA.flash_attention(q, k, v, **kw).float()
                    - FA.flash_attention_ref(q, k, v, **kw)
                    .float()).abs().max()))
    return row


def _qmm_layer_timing(device, proj: dict, m: int) -> dict:
    """W8A8 over one layer's projections ``proj`` ({(k, n): count}) at m
    rows: the kernel (twice), its plain version (twice) and
    ``torch._int_mm`` (m padded to 32 below it), weights rotated past
    L2, each
    shape's kernel equal to its plain version; summed over the layer."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import w8a8_matmul as W8
    rows = {}
    for (k, n), _ in proj.items():
        copies = -(-2 * L2_BYTES // (k * n)) + 1
        x, _, xs, ws = _qmm_operands(m, k, n, False, 7, device)
        wl = [_qmm_operands(m, k, n, False, 100 + c, device)[1]
              for c in range(copies)]
        check(bool(torch.equal(W8.w8a8_matmul(x, wl[0], xs, ws),
                               W8.w8a8_matmul_ref(x, wl[0], xs, ws))),
              f"W8A8 at {(m, k, n)} differs from its plain version")
        xp = F.pad(x, (0, 0, 0, max(0, 32 - m)))
        wcol = [w.t().contiguous().t() for w in wl]
        row = {"copies": copies, "regime": W8.plan(m, k, n).regime}
        for name, fn, iters in (
                ("plain", lambda i: W8.w8a8_matmul_ref(
                    x, wl[i % copies], xs, ws), 10),
                ("kernel", lambda i: W8.w8a8_matmul(
                    x, wl[i % copies], xs, ws), 200),
                ("kernel_again", lambda i: W8.w8a8_matmul(
                    x, wl[i % copies], xs, ws), 200),
                ("plain_again", lambda i: W8.w8a8_matmul_ref(
                    x, wl[i % copies], xs, ws), 10),
                ("library", lambda i: torch._int_mm(xp, wcol[i % copies]),
                 200)):
            row[f"{name}_ms"], row[f"{name}_event_ms"] = _device_ms(fn,
                                                                    iters)
        _best_times(row)
        bound = _bound(W8.cost(m, k, n))
        row.update(bytes=bound["bytes"], bound_ms=bound["bound_ms"],
                   bound_by=bound["bound_by"])
        rows[f"{k}x{n}"] = row
        del x, wl, wcol, xp
    layer = {key: sum(c * rows[f"{k}x{n}"][key]
                      for (k, n), c in proj.items())
             for key in ("best_kernel_ms", "best_plain_ms",
                         "best_library_ms", "bound_ms", "bytes")}
    bounds = {r["bound_by"] for r in rows.values()}
    layer.update(bound_by="bytes" if bounds == {"bytes"} else "operations",
                 timer="profiler" if all(r["timer"] == "profiler"
                                         for r in rows.values())
                 else "mixed", m=m,
                 projections={f"{k}x{n}": c for (k, n), c in proj.items()})
    return {"layer": layer, "shapes": rows}


def phase_moe_prefill(device, model, params) -> dict:
    """moonshot's 1 x 4096 forward at full depth on the kernel and plain
    routes: 4 W8A8 ``tc`` launches and one bf16 flash launch a layer;
    flash within 2e-2 of the plain route's attention (chunked above 2048
    tokens) on each layer's own q, k, v and each row within 2^-6 of its
    own max; the kernel route with that attention swapped in equal to the
    plain route bit for bit (logits and aux); the routing choices that
    differ between the unswapped routes and their logits' distance; aux;
    wall time, peak memory, the device-time split (W8A8 ``tc`` and flash
    by kernel name; the MoE layers as one layer's ``moe_ffn`` alone times
    the depth, of it the expert products alone by CUDA events; the rest)
    beside the expert products' bound; flash
    on layer 0's own q, k, v beside SDPA; W8A8 on a moonshot layer's
    projections at decode (m = 4)."""
    import torch
    from repro_torch.models import attention
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.model import EXPERT_NAMES, Model
    cfg = model.cfg
    plain = Model(cfg, device=device, impl="ref")
    L, s = cfg.n_layers, PREFILL["long_len"]
    tokens = torch.randint(0, cfg.vocab, (1, s), device=device,
                           generator=torch.Generator(device).manual_seed(3))
    real_route = moe_mod.topk_route
    fwd = {}
    for name, m in (("kernel", model), ("plain", plain)):
        m.forward(params, tokens, last_only=True)           # warm-up
        routes = []

        def recording(x, w, E, K):
            out = real_route(x, w, E, K)
            routes.append(out[1])
            return out
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        _reset_matmul_counts()
        _reset_attention_counts()
        moe_mod.topk_route = recording
        try:
            t0 = time.perf_counter()
            logits, aux = m.forward(params, tokens, last_only=True)
            torch.cuda.synchronize(device)
            wall = time.perf_counter() - t0
        finally:
            moe_mod.topk_route = real_route
        fwd[name] = {"logits": logits, "aux": aux, "wall_s": wall,
                     "routes": routes,
                     "peak_over_params_bytes":
                         torch.cuda.max_memory_allocated(device) - base,
                     "launches": {**_matmul_counts(),
                                  **_attention_counts()}}
    n = fwd["kernel"]["launches"]
    check(n["w8a8_matmul_tc"] == 4 * L and n["w8a8_matmul_dp4a"] == 0
          and n["flash_attention_tc"] == L and n["flash_attention"] == L
          and n["flash_attention_windowed"] == 0,
          f"{cfg.name} forward's launches {n}: {4 * L} W8A8 on the tensor "
          f"cores and {L} bf16 flash expected")
    check(fwd["plain"]["launches"]["flash_attention"] == 0
          and fwd["plain"]["launches"]["w8a8_matmul"] == 0,
          "plain route launched a kernel")
    lk, lp = fwd["kernel"]["logits"], fwd["plain"]["logits"]
    ak, ap = fwd["kernel"]["aux"], fwd["plain"]["aux"]
    check(tuple(lk.shape) == (1, 1, cfg.vocab)
          and bool(torch.isfinite(lk).all()),
          f"{cfg.name} forward logits {tuple(lk.shape)}")
    check(math.isfinite(float(ak)) and float(ak) > 0
          and math.isfinite(float(ap)) and float(ap) > 0,
          f"{cfg.name} aux {float(ak)!r} / {float(ap)!r}")
    routes_k, routes_p = fwd["kernel"]["routes"], fwd["plain"]["routes"]
    check(len(routes_k) == len(routes_p) == L, "routes recorded")
    differ = [int((a != c).sum()) for a, c in zip(routes_k, routes_p)]
    tokens_differ = [int((a.sort(-1).values != c.sort(-1).values)
                         .any(-1).sum()) for a, c in zip(routes_k, routes_p)]

    layers, kept = [], {}
    real_attend = attention.attend

    def swapped(q, k, v, *, causal=True, window=None, impl="auto"):
        got = real_attend(q, k, v, causal=causal, window=window, impl=impl)
        want = real_attend(q, k, v, causal=causal, window=window,
                           impl="ref")
        layers.append(flash_row_err(got, want))
        if not kept:
            kept["qkv"] = [t.transpose(1, 2).contiguous()
                           for t in (q, k, v)]
        return want
    attention.attend = swapped
    try:
        mixed, mixed_aux = model.forward(params, tokens, last_only=True)
    finally:
        attention.attend = real_attend
    check(len(layers) == L, "swapped attention calls")
    worst = max(e["max_abs"] for e in layers)
    worst_row = max(e["row_rel"] for e in layers)
    check(worst <= FLASH_TOL["bfloat16"] and worst_row <= FLASH_ROW_RTOL,
          f"{cfg.name}: flash vs plain attention {worst:.3g} absolute, "
          f"{worst_row:.3g} of a row's max on a layer")
    check(bool(torch.equal(mixed, lp)) and bool(torch.equal(mixed_aux, ap)),
          f"{cfg.name}: kernel route with plain attention differs from "
          f"the plain route")
    # one layer's moe_ffn and its expert products alone, at this
    # forward's shapes (layer 0's input)
    seen = {}
    real_ffn, real_experts = moe_mod.moe_ffn, moe_mod.expert_ffn

    def keep_ffn(x, p, cfg_, **kw):
        seen.setdefault("ffn", (x, p, kw))
        return real_ffn(x, p, cfg_, **kw)

    def keep_experts(buf, p, policy, train):
        seen.setdefault("experts", (buf, p, policy, train))
        return real_experts(buf, p, policy, train)
    moe_mod.moe_ffn, moe_mod.expert_ffn = keep_ffn, keep_experts
    try:
        model.forward(params, tokens, last_only=True)
    finally:
        moe_mod.moe_ffn, moe_mod.expert_ffn = real_ffn, real_experts
    x0, p0, kw0 = seen["ffn"]
    buf0 = seen["experts"][0]
    ffn_ms, ffn_event_ms = _device_ms(
        lambda i: real_ffn(x0, p0, cfg, **kw0), 5, windows=3)
    # the products with their silu * u
    exp_ms, exp_event_ms = _device_ms(
        lambda i: real_experts(*seen["experts"]), 5, windows=3)
    # the three expert products alone at layer 0's buffer and weights,
    # by CUDA events over back-to-back calls (device-bound: ~0.8 ms a
    # call against a few µs of launches); every layer's are the same
    # shapes.  (Their kernels cannot be picked out of the forward's
    # profile by name: a window can drop every record of one of them.)
    bufe, pe = seen["experts"][0], seen["experts"][1]
    wg, wi, wo = (pe[k] for k in EXPERT_NAMES)

    def products():
        g = torch.bmm(bufe, wg)
        torch.bmm(bufe, wi)
        torch.bmm(g, wo)
    products_ms = _event_ms(products, 10)
    prof = _profile_split(
        lambda: model.forward(params, tokens, last_only=True),
        {"flash": ("flash_tc_kernel",), "w8a8": ("w8a8_tc_kernel",)})
    E, C = buf0.shape[0], buf0.shape[1]
    expert_flops = 3 * 2 * E * C * cfg.d_model * cfg.d_ff * L
    total_ms = prof["profiled_device_ms"]
    split = {"w8a8_tc_device_ms": prof["w8a8_device_ms"],
             "flash_device_ms": prof["flash_device_ms"],
             "expert_products_layer_event_ms": products_ms,
             "expert_products_ms": products_ms * L}
    if ffn_ms is not None:
        # routing, dispatch, silu * u and the combine: the layer's
        # moe_ffn alone less its products, times the depth
        moe_ms = ffn_ms * L
        split.update(moe_other_ms=moe_ms - products_ms * L,
                     rest_device_ms=total_ms - prof["w8a8_device_ms"]
                     - prof["flash_device_ms"] - moe_ms)
    q, k, v = kept["qkv"]
    flash = _flash_timing(device, q, k, v)
    qmm = _qmm_layer_timing(device, MOE_LAYER_PROJ, SERVE["batch"])
    walls = {key: fwd[key]["wall_s"] for key in fwd}
    peak = fwd["kernel"]["peak_over_params_bytes"]
    out = {"phase": "moe_prefill", "arch": cfg.name, "forward_len": s,
           "capacity": C, "experts": E, "top_k": cfg.top_k,
           "forward_wall_s": walls["kernel"],
           "forward_plain_wall_s": walls["plain"],
           "peak_mem_over_params_bytes": peak, "launches": n,
           "aux": float(ak), "aux_plain": float(ap),
           "routing_entries_differing_per_layer": differ,
           "routing_tokens_differing_per_layer": tokens_differ,
           "routing_entries": s * cfg.top_k,
           "logits_max_abs_vs_plain": float(
               (lk.float() - lp.float()).abs().max()),
           "logits_max_abs": float(lp.float().abs().max()),
           "flash_vs_plain_per_layer_max_abs": [e["max_abs"]
                                                for e in layers],
           "flash_vs_plain_per_layer_row_rel": [e["row_rel"]
                                                for e in layers],
           "attention_out_per_layer_median_abs": [e["median_abs_want"]
                                                  for e in layers],
           "kernel_matmuls_plain_attention_equal_plain_route": True,
           "moe_ffn_layer_device_ms": ffn_ms,
           "moe_ffn_layer_event_ms": ffn_event_ms,
           "expert_ffn_layer_device_ms": exp_ms,
           "expert_ffn_layer_event_ms": exp_event_ms,
           "expert_products_flops": expert_flops,
           "expert_products_bound_ms":
               expert_flops / H100.peak_bf16_flops * 1e3,
           **prof, **split, "flash_timing": flash,
           "w8a8_decode_layer": qmm}
    del plain, fwd, mixed, kept, seen, x0, p0, buf0, q, k, v
    return out


def phase_moe_phi35(device) -> dict:
    """phi3.5-moe-42b-a6.6b at full width, depth cut to
    ``MOE_PHI["n_layers"]``: served as moonshot (``moe_serve``'s checks,
    the decode kernel never), the served stream teacher-forced on int8 KV
    (the decode kernel at rep 4), and bf16 flash at its prefill head
    count (1, 32, 4096, 128) on random q, k, v."""
    import torch
    arch, cut = MOE_PHI["arch"], MOE_PHI["n_layers"]
    built = _arch_model(arch, device, impl="kernel", n_layers=cut)
    serve_row = phase_arch_serve(device, arch, "moe_phi35_serve",
                                 built=built)
    stream = serve_row.pop("stream")
    int8kv = phase_moe_int8kv(device, "moe_phi35_int8kv", *built, stream)
    cfg = built[0].cfg
    del built
    g = torch.Generator(device).manual_seed(61)
    q, k, v = (torch.randn((1, cfg.n_heads, PREFILL["long_len"],
                            cfg.head_dim), generator=g, device=device)
               .to(torch.bfloat16) for _ in range(3))
    flash = _flash_timing(device, q, k, v)
    return {"phase": "moe_phi35", "arch": arch,
            "depth_cut": f"{cut} of 32 layers (32 layers of bf16 experts "
                         "are 80.5 GB)",
            "serve": serve_row, "int8kv": int8kv, "flash_timing": flash}


def _cross_counts(cfg) -> dict:
    """Kernel launches the vlm / audio paths make: W8A8 products and
    flash calls of a decode step, of ``fill_ctx_caches`` and of a forward
    (4 attention projections a layer and the MLP's 3 (swiglu) or 2
    (gelu); a cross layer's wq_x and wo_x at decode, and wk_img and
    wv_img too in a forward or a fill).  The vlm forward's cross
    attention takes the float32 flash route: its uncast context makes
    float32 keys and values under W8A8."""
    L, E = cfg.n_layers, cfg.encoder_layers
    vlm = cfg.family == "vlm"
    n_cross = L // cfg.cross_attn_every if vlm else L
    per = 4 + (3 if cfg.mlp_kind == "swiglu" else 2)
    return {"n_cross": n_cross,
            "decode_w8a8": per * L + 2 * n_cross, "decode_flash": n_cross,
            "fill_w8a8": per * E + 2 * n_cross, "fill_flash": E,
            "forward_w8a8": per * (L + E) + 4 * n_cross,
            "forward_flash_tc": L + E + (0 if vlm else n_cross),
            "forward_flash_f32": n_cross if vlm else 0}


def _cross_ctx(cfg, batch: int, device):
    """The context ``serve`` draws: (batch, n_ctx, d) x 0.02 from seed +
    2."""
    import torch
    return torch.randn((batch, cfg.n_ctx_tokens, cfg.d_model),
                       generator=torch.Generator(device).manual_seed(
                           SERVE["seed"] + 2), device=device) * 0.02


class _swapped_attention:
    """Inside the ``with`` block, ``attention.attend`` computes both
    routes' attention, records the kernel's distance to the plain one
    (``flash_row_err``) with the application's kind (``cross``,
    ``encoder``: causal over the context's length, or ``self``) and
    returns the plain one; the first application of each kind keeps its
    q, k, v as (b, h, s, d), in the dtype the kernel takes them in."""

    def __init__(self, n_ctx: int):
        self.n_ctx, self.apps, self.kept = n_ctx, [], {}

    def __enter__(self):
        import torch
        from repro_torch.models import attention
        self.real = real = attention.attend

        def swapped(q, k, v, *, causal=True, window=None, impl="auto"):
            got = real(q, k, v, causal=causal, window=window, impl=impl)
            want = real(q, k, v, causal=causal, window=window, impl="ref")
            kind = "cross" if not causal else (
                "encoder" if q.shape[1] == self.n_ctx else "self")
            self.apps.append(dict(flash_row_err(got, want), kind=kind))
            if kind not in self.kept:
                dt = q.dtype if q.dtype == k.dtype else torch.float32
                self.kept[kind] = [t.transpose(1, 2).to(dt).contiguous()
                                   for t in (q, k, v)]
            return want
        attention.attend = swapped
        return self

    def __exit__(self, *exc):
        from repro_torch.models import attention
        attention.attend = self.real
        return False

    def summary(self, what: str) -> dict:
        """Per kind: applications, the worst absolute, scaled and row
        errors, the largest |out| and median |out|; fails past the bf16
        bound: each element within 2e-2 x (1 + its |out|), the CPU tests'
        ``rtol = atol = 2e-2`` (these models' attention outputs pass 4,
        where one bf16 ulp is 2^-5 > 2e-2), and each row within 2^-6 of
        its own max."""
        out = {}
        for kind in sorted({a["kind"] for a in self.apps}):
            rows = [a for a in self.apps if a["kind"] == kind]
            worst = max(a["scaled"] for a in rows)
            worst_row = max(a["row_rel"] for a in rows)
            check(worst <= FLASH_TOL["bfloat16"]
                  and worst_row <= FLASH_ROW_RTOL,
                  f"{what}: {kind} flash vs plain attention {worst:.3g} of "
                  f"1 + |out|, {worst_row:.3g} of a row's max")
            out[kind] = {"applications": len(rows),
                         "max_abs": max(a["max_abs"] for a in rows),
                         "scaled": worst, "row_rel": worst_row,
                         "max_abs_out": max(a["max_abs_want"] for a in rows),
                         "median_abs_out": max(a["median_abs_want"]
                                               for a in rows)}
        return out


def _nbytes(t) -> int:
    """Bytes of a tensor, or of a quantized one with its scales."""
    if hasattr(t, "scale"):
        return t.data.numel() * t.data.element_size() \
            + t.scale.numel() * t.scale.element_size()
    return t.numel() * t.element_size()


def _stored_bytes(params: dict, names=None) -> int:
    """Bytes of every tensor of ``params`` (of the layer entries in
    ``names`` only, where given)."""
    total = 0
    for val in params.values():
        for lp in val if isinstance(val, list) else [val]:
            if not isinstance(lp, dict):
                total += _nbytes(lp)
                continue
            total += sum(_nbytes(t) for key, t in lp.items()
                         if names is None or key in names)
    return total


def phase_cross_serve(device, family: str, model, params) -> dict:
    """The vlm or audio model served through ``fill_ctx_caches`` and
    ``launch.serve.generate`` (SERVE: batch 4, 8 + 8 tokens) on a
    context drawn as ``serve`` draws it: the fill's time (whisper's
    encoder alone too) and launches (W8A8 ``tc`` at m = 4 x n_ctx, the
    encoder's flash), a step's W8A8 products all on the split-k regime
    and one bf16 flash launch a cross layer, nothing else; the served
    stream teacher-forced through the kernel route, the kernel route with
    the plain attention swapped in and the plain route: the swapped and
    plain routes' context caches, logits and every cache bit for bit
    after each step, flash within 2e-2 x (1 + |out|) (and 2^-6 a row) of
    the plain attention on every application, the unswapped routes' logits
    distance reported (C.3); one profiled step; flash at the decode's
    cross shape, the GQA repeat of a cross layer's context caches and
    W8A8 at ``context_kv``'s shape, timed."""
    import torch
    from repro_torch.launch.serve import fill_ctx_caches, generate
    from repro_torch.models import attention
    from repro_torch.models.model import Model
    spec, cfg = CROSS_ARCHS[family], model.cfg
    name = f"{family}_serve"
    counts = _cross_counts(cfg)
    b, gen = SERVE["batch"], SERVE["gen"]
    steps = SERVE["prompt_len"] + gen
    prompts = torch.randint(
        0, cfg.vocab, (b, SERVE["prompt_len"]), device=device,
        generator=torch.Generator(device).manual_seed(SERVE["seed"] + 1))
    ctx = _cross_ctx(cfg, b, device)
    fill_ctx_caches(model, params, model.init_cache(b, steps), ctx)  # warm
    caches = model.init_cache(b, steps)
    _reset_matmul_counts()
    _reset_attention_counts()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    fill_ctx_caches(model, params, caches, ctx)
    torch.cuda.synchronize(device)
    fill_ms = (time.perf_counter() - t0) * 1e3
    fill_launches = {**_matmul_counts(), **_attention_counts()}
    check(fill_launches["w8a8_matmul_tc"] == counts["fill_w8a8"]
          and fill_launches["w8a8_matmul_dp4a"] == 0
          and fill_launches["flash_attention_tc"] == counts["fill_flash"]
          and fill_launches["flash_attention"] == counts["fill_flash"],
          f"{name}: fill_ctx_caches launched {fill_launches}, expected "
          f"{counts['fill_w8a8']} W8A8 tc and {counts['fill_flash']} flash")
    encoder_ms = None
    if family == "audio":
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        model._encode(params, ctx)
        torch.cuda.synchronize(device)
        encoder_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.reset_peak_memory_stats(device)
    _reset_matmul_counts()
    _reset_attention_counts()
    res = generate(model, params, prompts, gen=gen, caches=caches)
    launches = {**_matmul_counts(), **_attention_counts()}
    peak = torch.cuda.max_memory_allocated(device)
    want_mm, want_fl = steps * counts["decode_w8a8"], \
        steps * counts["decode_flash"]
    check(launches["w8a8_matmul"] == want_mm
          and launches["w8a8_matmul_dp4a"] == want_mm
          and launches["flash_attention"] == want_fl
          and launches["flash_attention_tc"] == want_fl
          and launches["flash_attention_windowed"] == 0
          and launches["w4a8_matmul"] == 0
          and launches["w8a8_decode_attention"] == 0,
          f"{name}: launches {launches}, expected {want_mm} W8A8 split-k "
          f"and {want_fl} bf16 flash")
    toks = res["tokens"]
    check(tuple(toks.shape) == (b, gen) and int(toks.min()) >= 0
          and int(toks.max()) < cfg.vocab,
          f"{name}: tokens {tuple(toks.shape)} outside [0, vocab)")
    cache_bytes = sum(t.numel() * t.element_size() for t in caches.values())
    del caches

    # the served stream through the three routes
    stream = torch.cat([prompts, toks.to(prompts.dtype)], dim=1)
    plain = Model(cfg, device=device, impl="ref")
    swap = _swapped_attention(cfg.n_ctx_tokens)
    ck = fill_ctx_caches(model, params, model.init_cache(b, steps + 1), ctx)
    with swap:
        cs = fill_ctx_caches(model, params, model.init_cache(b, steps + 1),
                             ctx)
    cp = fill_ctx_caches(plain, params, plain.init_cache(b, steps + 1), ctx)
    check(all(torch.equal(cs[k], cp[k]) for k in ("ctx_k", "ctx_v")),
          f"{name}: swapped and plain context caches differ")
    worst_abs, agree, same = 0.0, [], True
    for i in range(steps):
        tok = stream[:, i:i + 1]
        lk, ck = model.decode_step(params, ck, tok, i)
        with swap:
            ls, cs = model.decode_step(params, cs, tok, i)
        lp, cp = plain.decode_step(params, cp, tok, i)
        check(bool(torch.isfinite(lk).all()), f"{name}: non-finite logits")
        same &= bool(torch.equal(ls, lp)) \
            and all(torch.equal(cs[k], cp[k]) for k in cp)
        worst_abs = max(worst_abs, float((lk.float() - lp.float()).abs()
                                         .max()))
        agree.append(float((lk.argmax(-1) == lp.argmax(-1)).float().mean()))
    check(same, f"{name}: kernel route with plain attention differs from "
                f"the plain route (logits or caches)")
    flash_apps = swap.summary(name)
    check(flash_apps["cross"]["applications"]
          == steps * counts["decode_flash"], f"{name}: cross applications")
    tok = stream[:, -1:]

    def step(_):
        model.decode_step(params, ck, tok, steps)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    step(0)
    torch.cuda.synchronize(device)
    step_wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, top, ops, _ = _profile_device_ms(step, BUSY_STEPS)
    weight_bytes = _stored_bytes(params)
    # a step reads the decoder's layers, the cross layers' wq_x and wo_x,
    # the float32 embedding (the logits product) and the context caches
    step_bytes = _stored_bytes(
        {"embed": params["embed"], "layers": params["layers"],
         "cross_layers": params["cross_layers"]},
        names=PROJ_NAMES_DECODE) + 2 * _nbytes(ck["ctx_k"])
    q, k, v = swap.kept["cross"]
    flash = _flash_timing(device, q, k, v, causal=False)
    # what a cross layer's GQA repeat of its context caches to n_heads
    # costs a step (none at rep 1)
    repeat_ms = None
    if cfg.n_heads != cfg.n_kv_heads:
        xk, xv = ck["ctx_k"][0], ck["ctx_v"][0]
        repeat_ms = _device_ms(lambda i: (
            attention._broadcast_kv(xk, cfg.n_heads),
            attention._broadcast_kv(xv, cfg.n_heads)), 10)
    kvw = cfg.n_kv_heads * cfg.head_dim
    qmm = _qmm_layer_timing(device, {(cfg.d_model, kvw): 2},
                            b * cfg.n_ctx_tokens)
    del plain, ck, cs, cp, swap, q, k, v
    cut = spec["n_layers"]
    return {"phase": name, "arch": cfg.name, "n_layers": cfg.n_layers,
            "depth_cut": (f"n_layers {spec['full_layers']} -> {cut}, "
                          "nothing else") if cut else None,
            "encoder_layers": cfg.encoder_layers,
            "cross_layers": counts["n_cross"], "n_ctx": cfg.n_ctx_tokens,
            "launches": launches, "fill_launches": fill_launches,
            "w8a8_per_step": counts["decode_w8a8"],
            "flash_per_step": counts["decode_flash"],
            "fill_ctx_caches_ms": fill_ms, "encoder_ms": encoder_ms,
            "prefill_s": res["prefill_s"], "decode_s": res["decode_s"],
            "decode_step_ms": res["decode_s"] / gen * 1e3,
            "tok_per_s": res["tok_per_s"], "peak_mem_bytes": peak,
            "weight_bytes": weight_bytes, "cache_bytes": cache_bytes,
            "tokens_head": toks[0, :8].tolist(), "parity_steps": steps,
            "swapped_route_equals_plain": True,
            "flash_vs_plain": flash_apps,
            "logits_kernel_vs_plain_max_abs": worst_abs,
            "greedy_agreement_per_step": agree,
            "step_wall_ms": step_wall_ms, "step_device_ms": busy_ms,
            "device_busy_share": (busy_ms / step_wall_ms
                                  if busy_ms else None),
            "step_device_ops": ops, "step_top_kernels_ms": top,
            "step_bytes": step_bytes,
            "step_bound_ms": step_bytes / H100.hbm_bw * 1e3,
            "flash_timing": flash, "w8a8_context_kv": qmm,
            "broadcast_kv_layer_ms": repeat_ms}


def phase_cross_prefill(device, family: str, model, params) -> dict:
    """The vlm's 1 x 4096 or the audio model's 4 x 448 forward with a
    context, on the kernel and plain routes: wall times, launches (every
    projection on the tensor cores; flash for every self-attention, the
    encoder's and every cross layer's, the vlm's cross layers on the
    float32 route), finite logits; flash within 2e-2 x (1 + |out|) (and
    2^-6 a row) of the plain attention on each application's own q, k,
    v, and the kernel route with that attention swapped in equal to the
    plain route bit for bit; the device time split: W8A8 ``tc`` and flash
    by kernel name, each kind of flash application timed alone times its
    count, the rest."""
    import torch
    from repro_torch.models.model import Model
    spec, cfg = CROSS_ARCHS[family], model.cfg
    name = f"{family}_prefill"
    counts = _cross_counts(cfg)
    b, s = spec["forward"]
    tokens = torch.randint(0, cfg.vocab, (b, s), device=device,
                           generator=torch.Generator(device).manual_seed(3))
    ctx = _cross_ctx(cfg, b, device)
    plain = Model(cfg, device=device, impl="ref")
    model.forward(params, tokens, ctx=ctx, last_only=True)     # warm-up
    fwd = {}
    for route, m in (("kernel", model), ("plain", plain)):
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        _reset_matmul_counts()
        _reset_attention_counts()
        t0 = time.perf_counter()
        logits, _ = m.forward(params, tokens, ctx=ctx, last_only=True)
        torch.cuda.synchronize(device)
        fwd[route] = {"logits": logits,
                      "wall_s": time.perf_counter() - t0,
                      "peak_over_params_bytes":
                          torch.cuda.max_memory_allocated(device) - base,
                      "launches": {**_matmul_counts(),
                                   **_attention_counts()}}
    n = fwd["kernel"]["launches"]
    check(n["w8a8_matmul_tc"] == counts["forward_w8a8"]
          and n["w8a8_matmul_dp4a"] == 0
          and n["flash_attention_tc"] == counts["forward_flash_tc"]
          and n["flash_attention_f32"] == counts["forward_flash_f32"]
          and n["flash_attention_windowed"] == 0,
          f"{name}: launches {n}, expected {counts['forward_w8a8']} W8A8 "
          f"tc, {counts['forward_flash_tc']} bf16 and "
          f"{counts['forward_flash_f32']} float32 flash")
    check(fwd["plain"]["launches"]["w8a8_matmul"] == 0
          and fwd["plain"]["launches"]["flash_attention"] == 0,
          f"{name}: the plain route launched a kernel")
    lk, lp = fwd["kernel"]["logits"], fwd["plain"]["logits"]
    check(tuple(lk.shape) == (b, 1, cfg.vocab)
          and bool(torch.isfinite(lk).all()),
          f"{name}: logits {tuple(lk.shape)}")
    swap = _swapped_attention(cfg.n_ctx_tokens)
    with swap:
        mixed, _ = model.forward(params, tokens, ctx=ctx, last_only=True)
    check(bool(torch.equal(mixed, lp)),
          f"{name}: kernel route with plain attention differs from the "
          f"plain route")
    flash_apps = swap.summary(name)
    prof = _profile_split(
        lambda: model.forward(params, tokens, ctx=ctx, last_only=True),
        {"w8a8_tc": ("w8a8_tc_kernel",), "flash_tc": ("flash_tc_kernel",),
         "flash_f32": ("flash_kernel",)})
    alone, split = {}, {}
    for kind, (q, k, v) in swap.kept.items():
        alone[kind] = _flash_timing(device, q, k, v,
                                    causal=kind != "cross")
        split[f"flash_{kind}_ms"] = alone[kind]["best_kernel_ms"] \
            * flash_apps[kind]["applications"]
    flash_by_name = prof["flash_tc_device_ms"] + prof["flash_f32_device_ms"]
    split["rest_device_ms"] = prof["profiled_device_ms"] \
        - prof["w8a8_tc_device_ms"] - flash_by_name
    out = {"phase": name, "arch": cfg.name, "n_layers": cfg.n_layers,
           "encoder_layers": cfg.encoder_layers,
           "cross_layers": counts["n_cross"], "forward_shape": [b, s],
           "n_ctx": cfg.n_ctx_tokens,
           "forward_wall_s": fwd["kernel"]["wall_s"],
           "forward_plain_wall_s": fwd["plain"]["wall_s"],
           "peak_mem_over_params_bytes":
               fwd["kernel"]["peak_over_params_bytes"],
           "launches": n,
           "logits_max_abs_vs_plain": float(
               (lk.float() - lp.float()).abs().max()),
           "logits_max_abs": float(lp.float().abs().max()),
           "flash_vs_plain": flash_apps,
           "kernel_matmuls_plain_attention_equal_plain_route": True,
           **prof, "flash_device_ms_by_name": flash_by_name, **split,
           "flash_timing": alone}
    del plain, fwd, mixed, swap, lk, lp
    return out


def _decode_operands(b, kvh, rep, hd, S, seed, device):
    import torch
    g = torch.Generator(device).manual_seed(seed)
    q = torch.randn((b, kvh, rep, hd), generator=g, device=device)
    kq, vq = (torch.randint(-127, 128, (b, S, kvh, hd), generator=g,
                            device=device, dtype=torch.int32)
              .to(torch.int8) for _ in range(2))
    ks, vs = (torch.rand((b, S, kvh), generator=g, device=device) * 0.02
              + 1e-3 for _ in range(2))
    return q, kq, vq, ks, vs


def phase_attention_parity(device) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import _mask
    rows = []
    worst = {"decode": [0.0, 0.0], "flash": [0.0, 0.0],
             "flash_bfloat16": [0.0, 0.0], "flash_float32": [0.0, 0.0]}
    from repro_torch.kernels.w8a8_decode import plan as decode_plan
    b, kvh, rep, hd = DECODE_SHAPE
    S = DECODE_S[0]
    for i, (shape, bs) in enumerate((((b, kvh, rep, hd), S),
                                     ((b, kvh, rep, hd), 512),
                                     ((b, kvh, 1, hd), S),
                                     ((b, kvh, 8, hd), 512),
                                     ((b, kvh, rep, 64), S))):
        split = decode_plan(*shape, S, bs)
        # inside the first split, on either side of a split boundary, last
        pos = torch.tensor([7, split.split_keys - 1, split.split_keys,
                            S - 1], dtype=torch.int32, device=device)
        args = _decode_operands(*shape, S, 10 + i, device)
        got = ops.w8a8_decode_attention(*args, pos, bs=bs, impl="kernel")
        want = ops.w8a8_decode_attention(*args, pos, bs=bs, impl="ref")
        torch.cuda.synchronize(device)
        check(bool(torch.isfinite(got).all()), "non-finite decode output")
        err = float((got - want).abs().max())
        rel = err / max(float(want.abs().max()), 1e-30)
        check(rel <= DECODE_TOL,
              f"decode kernel vs plain {rel:.3g} x max|out| at {shape}, "
              f"bs {bs}")
        check(bool(torch.equal(got, want)),
              f"decode kernel not bit-identical to plain at {shape}, bs {bs}")
        worst["decode"] = [max(worst["decode"][0], err),
                           max(worst["decode"][1], rel)]
        rows.append({"kernel": "decode", "shape": list(shape), "S": S,
                     "bs": bs, "splits": split.splits,
                     "positions": pos.tolist(), "max_abs": err,
                     "rel_to_max": rel})

    cases = [  # (b, h, sq, sk, d, causal, window)
        (1, 4, 512, 512, 128, True, None),
        (1, 4, 256, 1024, 128, True, None),
        (1, 4, 2048, 2048, 128, True, 16),
        (1, 4, 2048, 2048, 128, True, 48),
        (1, 4, 2048, 2048, 128, True, 1024),
        (2, 4, 512, 512, 128, False, None),
        (1, 4, 77, 77, 128, True, None),
        (1, 4, 1000, 1000, 128, True, None),
        (1, 4, 77, 1000, 64, True, None),
        (1, 2, 300, 300, 16, True, None),
        (1, 2, 333, 333, 32, False, 40),
        (1, 2, 500, 500, 256, True, None),
    ]
    for i, (bb, h, sq, sk, d, causal, window) in enumerate(cases):
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator(device).manual_seed(100 + i)
            q, k, v = (torch.randn((bb, h, s, d), generator=g,
                                   device=device).to(dtype)
                       for s in (sq, sk, sk))
            got = ops.flash_attention(q, k, v, causal=causal, window=window,
                                      impl="kernel")
            want = ops.flash_attention(q, k, v, causal=causal,
                                       window=window, impl="ref")
            lib = F.scaled_dot_product_attention(
                q, k, v, attn_mask=_mask(sq, sk, causal, window, device))
            torch.cuda.synchronize(device)
            check(bool(torch.isfinite(got).all()), "non-finite flash output")
            err = float((got.float() - want.float()).abs().max())
            tol = FLASH_TOL[str(dtype).split(".")[1]]
            check(err <= tol, f"flash kernel vs plain {err:.3g} > {tol} at "
                              f"{(bb, h, sq, sk, d, causal, window, dtype)}")
            rel = err / max(float(want.float().abs().max()), 1e-30)
            row_err = flash_row_err(got, want)
            for key in ("flash", f"flash_{str(dtype).split('.')[1]}"):
                worst[key] = [max(worst[key][0], err),
                              max(worst[key][1], rel)]
            rows.append({"kernel": "flash", "case": [bb, h, sq, sk, d,
                                                     causal, window],
                         "dtype": str(dtype), "max_abs": err,
                         "rel_to_max": rel, "row_rel": row_err["row_rel"],
                         "median_abs_out": row_err["median_abs_want"],
                         "sdpa_max_abs": float((lib.float()
                                                - got.float()).abs().max())})
    return {"phase": "attention_parity", "rows": rows, "worst": worst}


def _decode_timing(device, shape, S: int) -> dict:
    """The decode-attention kernel and its plain version at ``shape`` =
    (b, kvh, rep, hd) and S keys, bs = S: first held to each other on the
    first operand set with per-row positions inside the first split, on
    either side of a split boundary and at S - 1 (bit for bit, and within
    ``DECODE_TOL`` x max|out|); then timed with every key live, inputs
    rotated past L2, in turns (plain, kernel, kernel, plain); the grid and
    the launches per call its C entry reports, and the call's bound."""
    import torch
    from repro_torch.kernels import w8a8_decode as D
    b, kvh, rep, hd = shape
    kv_bytes = 2 * b * S * kvh * (hd + 4)
    copies = -(-2 * L2_BYTES // kv_bytes) + 1
    sets = [_decode_operands(b, kvh, rep, hd, S, 50 + c, device)
            for c in range(copies)]
    pos = torch.full((b,), S - 1, dtype=torch.int32, device=device)
    coded = [D.quantize_q(s[0]) + s[1:] for s in sets]
    split = D.plan(b, kvh, rep, hd, S, S)
    row = {"shape": [b, kvh, rep, hd, S], "copies": copies,
           "planned_splits": split.splits, "split_keys": split.split_keys}
    marks = (7, split.split_keys - 1, split.split_keys, S - 1)
    at = torch.tensor([min(marks[i % 4], S - 1) for i in range(b)],
                      dtype=torch.int32, device=device)
    got = D.w8a8_decode_attention_body(*coded[0], at, bs=S)
    want = D.w8a8_decode_attention_body_ref(*coded[0], at, bs=S)
    torch.cuda.synchronize(device)
    check(bool(torch.isfinite(got).all()),
          f"non-finite decode output at {row['shape']}")
    err = float((got - want).abs().max())
    rel = err / max(float(want.abs().max()), 1e-30)
    check(rel <= DECODE_TOL, f"decode kernel vs plain {rel:.3g} x max|out| "
                             f"at {row['shape']}")
    check(bool(torch.equal(got, want)),
          f"decode kernel not bit-identical to plain at {row['shape']}")
    row.update(positions=at.tolist(), max_abs_err=err, rel_to_max=rel)
    calls, kernels, D.last_grid = D.launches, D.kernel_launches, None
    seen = {}
    for name, fn, iters in (
            ("plain", D.w8a8_decode_attention_body_ref, 3),
            ("kernel", D.w8a8_decode_attention_body, 50),
            ("kernel_again", D.w8a8_decode_attention_body, 50),
            ("plain_again", D.w8a8_decode_attention_body_ref, 3)):
        row[f"{name}_ms"], row[f"{name}_event_ms"] = _device_ms(
            lambda i, fn=fn: fn(*coded[i % copies], pos, bs=S), iters,
            windows=3, seen=seen if name == "kernel" else None)
    calls, kernels = D.launches - calls, D.kernel_launches - kernels
    row.update(grid=list(D.last_grid), splits=D.last_grid[1],
               blocks=D.last_grid[0] * D.last_grid[1],
               launches_per_call=kernels / calls,
               profiler_ops_per_call=seen.get("ops"))
    check(tuple(D.last_grid) == (b * kvh, split.splits),
          f"decode grid {D.last_grid}, planned ({b * kvh}, "
          f"{split.splits})")
    check(row["blocks"] >= H100_SMS,
          f"decode grid of {row['blocks']} blocks at S {S}")
    bound = _bound(D.cost(b, kvh, rep, hd, [S] * b))
    row.update(int8_ops=bound.pop("ops"), **bound)
    _best_times(row)
    return row


def _best_times(row: dict) -> None:
    """``timer`` (profiler where every turn has device time, else CUDA
    events) and the best of the kernel's and the plain version's turns
    (and the library call's, where timed) by that timer."""
    keys = ["kernel", "kernel_again", "plain", "plain_again"] + (
        ["library"] if "library_ms" in row else [])
    row["timer"] = "profiler" if all(row[f"{k}_ms"] is not None
                                     for k in keys) else "event"
    suffix = "_ms" if row["timer"] == "profiler" else "_event_ms"
    row["best_kernel_ms"] = min(row["kernel" + suffix],
                                row["kernel_again" + suffix])
    row["best_plain_ms"] = min(row["plain" + suffix],
                               row["plain_again" + suffix])
    if "library_ms" in row:
        row["best_library_ms"] = row["library" + suffix]


def phase_attention_timing(device) -> dict:
    """Device time per call, in turns (plain, kernel, kernel, plain).
    Decode attention's grid and launches per call are what its C entry
    reports it launched in these calls (the profiler's device operations
    per call stand beside); SDPA's kernel is the top kernel of the
    profiler window that times it (None where that window kept no
    record)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    out = {"decode": {str(S): _decode_timing(device, DECODE_SHAPE, S)
                      for S in DECODE_S}, "flash": {}}

    bb, h, s, d = FLASH_SHAPE
    for key, dtype in (("flash", torch.bfloat16), ("flash_f32", torch.float32)):
        g = torch.Generator(device).manual_seed(60)
        q, k, v = (torch.randn((bb, h, s, d), generator=g, device=device)
                   .to(dtype) for _ in range(3))
        row = {"dtype": str(dtype)}
        seen = {}
        for name, fn, iters in (
                ("plain", lambda i: FA.flash_attention_ref(q, k, v), 3),
                ("kernel", lambda i: FA.flash_attention(q, k, v), 10),
                ("kernel_again", lambda i: FA.flash_attention(q, k, v), 10),
                ("plain_again", lambda i: FA.flash_attention_ref(q, k, v),
                 3),
                ("library", lambda i: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True), 20)):
            # the largest of three profiler windows: a window that drops
            # records can read a call at half its events' time
            row[f"{name}_ms"], row[f"{name}_event_ms"] = _device_ms(
                fn, iters, windows=3,
                seen=seen if name == "library" else None)
        row["library_kernel"] = seen["top"][0][0] if seen.get("top") \
            else None
        # the kernel and SDPA against the plain version at this shape
        want = FA.flash_attention_ref(q, k, v).float()
        row["kernel_max_abs_vs_plain"] = float(
            (FA.flash_attention(q, k, v).float() - want).abs().max())
        row["library_max_abs_vs_plain"] = float(
            (F.scaled_dot_product_attention(q, k, v, is_causal=True).float()
             - want).abs().max())
        del want
        if dtype == torch.bfloat16:
            # the kernel's records kept by the profiler, and its time
            # sustained over ~1 s with the SM clock and power sampled
            # beside it
            row["kernel_profiler_records_kept"] = _profile_device_ms(
                lambda i: FA.flash_attention(q, k, v), 10)[3]
            with _ClockSampler() as clocks:
                row["kernel_sustained_event_ms"] = _event_ms(
                    lambda: FA.flash_attention(q, k, v), 200)
            row["kernel_sustained_clocks"] = clocks.summary()
        bound = _bound(FA.cost(bb, h, s, s, d, causal=True, window=None,
                               dtype=dtype))
        flops = bound.pop("ops")
        if dtype == torch.bfloat16:
            peak = H100.peak_bf16_flops
        else:
            # 3xTF32 on the tensor cores; the CUDA cores' float32 rate
            # stated beside it
            peak = H100.peak_tf32_flops
            row["ops_cuda_core_ms"] = flops / H100.peak_fp32_flops * 1e3
        row.update(flops=flops, peak_flops=peak, **bound)
        out[key] = row
        del q, k, v

    # device time from the profiler; CUDA events where it gave none
    for r in (out["flash"], out["flash_f32"]):
        _best_times(r)
    for key in ("flash", "flash_f32"):
        out[key]["tflops"] = flops / (out[key]["best_kernel_ms"]
                                      * 1e-3) / 1e12
    return {"phase": "attention_timing", **out}


# ------------------------------------- accuracy tiers 1 and 2, training

def _tier_fields(tab) -> dict:
    return {f: getattr(tab, f) for f in (
        "table", "per_tensor_table", "act_noise", "absmax", "scale_pctl",
        "std")}


def phase_calibrate(device, cache_dir: str) -> dict:
    """The tier-1 table of each ``CALIBRATE`` model (full depth, reduced
    width, the port's own draw) measured on the card into an empty cache,
    read back from it (a hit), and measured again on the CPU: every field
    within ``CALIBRATE["rtol"]`` relative of the CPU's, element by
    element."""
    import numpy as np
    import torch
    from repro_torch.quant import calibrate as C
    out = {"phase": "calibrate", "rtol": CALIBRATE["rtol"], "models": {}}
    for arch in CALIBRATE["archs"]:
        C.reset_calibration_cache_stats()
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        card = C.calibrate_model(arch, cache_dir=cache_dir, device=device)
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        again = C.calibrate_model(arch, cache_dir=cache_dir, device=device)
        hit_s = time.perf_counter() - t0
        stats = C.calibration_cache_stats()
        check(stats == {"hits": 1, "misses": 1}
              and again.digest() == card.digest(),
              f"calibrate {arch}: cache {stats}, digests {card.digest()} / "
              f"{again.digest()}")
        t0 = time.perf_counter()
        cpu = C._measure(arch, card.seed, card.percentile, card.per_channel,
                         device="cpu")
        cpu_s = time.perf_counter() - t0
        dist = {f: rel_err(v, getattr(cpu, f))
                for f, v in _tier_fields(card).items()}
        same = all(np.array_equal(v, getattr(cpu, f))
                   for f, v in _tier_fields(card).items())
        check(max(dist.values()) <= CALIBRATE["rtol"],
              f"calibrate {arch}: card vs CPU {dist}")
        out["models"][arch] = {
            "layers": card.n_layers, "card_s": card_s,
            "cache_hit_s": hit_s, "cpu_s": cpu_s, "digest": card.digest(),
            "cpu_digest": cpu.digest(), "bit_identical": same,
            "rel_dist": dist, "max_rel_dist": max(dist.values()),
            "cache": stats}
    return out


def _distinct_plans(res, n_model_layers: int, elites) -> int:
    import numpy as np
    _, assign = res.space.decode(res.genomes)
    wl_of = (np.arange(n_model_layers) * assign.shape[1]) // n_model_layers
    return len(np.unique(assign[elites][:, wl_of], axis=0))


def phase_validate_elites(device, cache_dir: str) -> dict:
    """Tier 2.  A ``calibrated-quick``-shaped ``measured:mamba2-130m``
    search (budget and population cut) on the card and on the CPU, both
    scored with the card's table: the same front, so the same elites and
    plans; ``validate_elites`` of the card's result on the card and on the
    CPU: per-plan and baseline losses within the bf16 loss bar, seconds
    per distinct plan.  Then phi4-mini-3.8b (32 layers, reduced width):
    its elites' losses on the card go through the flash kernel (launches
    counted: one a layer a loss), beside the CPU's plain route."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core.dse import ExploreSpec, run
    from repro_torch.explore.accuracy import (AccuracySpec,
                                              CalibratedAccuracy,
                                              validate_elites)
    from repro_torch.quant.calibrate import calibration_config
    V = VALIDATE
    out = {"phase": "validate_elites", "loss_rtol": V["loss_rtol"]}
    for arch in (V["model"], V["attention_model"]):
        spec = AccuracySpec(tier=2, model=arch, cache_dir=cache_dir,
                            max_elites=V["max_elites"])
        acc = CalibratedAccuracy(spec, device=device)
        search = ExploreSpec.mixed(V["workload"], preset=V["preset"],
                                   budget=V["budget"],
                                   pop_size=V["pop_size"], accuracy=acc)
        row = {}
        if arch == V["model"]:
            t0 = time.perf_counter()
            card_res = run(search, device=device)
            torch.cuda.synchronize(device)
            row["card_search_and_validation_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            cpu_res = run(search, device="cpu")
            row["cpu_search_and_validation_s"] = time.perf_counter() - t0
            check(np.array_equal(card_res.genomes, cpu_res.genomes),
                  f"validate_elites {arch}: the card's and the CPU's fronts "
                  f"differ")
            attached = card_res.validation
        else:   # a tier-1 search, then the validation alone
            card_res = run(dataclasses.replace(
                search, accuracy=CalibratedAccuracy(
                    dataclasses.replace(spec, tier=1), device=device)),
                device=device)
            attached = None
        _reset_attention_counts()
        _reset_matmul_counts()
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        card = validate_elites(card_res, acc, device=device)
        torch.cuda.synchronize(device)
        card_s = time.perf_counter() - t0
        launches = {**_attention_counts(), **_matmul_counts()}
        t0 = time.perf_counter()
        cpu = validate_elites(card_res, acc, device="cpu")
        cpu_s = time.perf_counter() - t0
        lm = calibration_config(arch).n_layers
        plans = _distinct_plans(card_res, lm, card.elite_indices)
        losses_card = np.r_[card.baseline_loss, card.quant_loss]
        losses_cpu = np.r_[cpu.baseline_loss, cpu.quant_loss]
        rel = rel_err(losses_card, losses_cpu)
        check(np.array_equal(card.elite_indices, cpu.elite_indices),
              f"validate_elites {arch}: elites differ")
        if attached is not None:
            check(np.array_equal(attached.quant_loss, card.quant_loss)
                  and attached.baseline_loss == card.baseline_loss,
                  f"validate_elites {arch}: run()'s attached validation "
                  f"differs from a second one on the card")
        check(rel <= V["loss_rtol"],
              f"validate_elites {arch}: losses card vs CPU {rel:.3g}")
        flash = launches["flash_attention"]
        if arch == V["attention_model"]:
            check(flash == lm * (plans + 1),
                  f"validate_elites {arch}: {flash} flash launches for "
                  f"{plans} plans + the baseline, {lm} layers")
        check(launches["w8a8_matmul"] + launches["w4a8_matmul"] == 0,
              f"validate_elites {arch}: quantized matmul launches "
              f"{launches}")
        row.update({
            "layers": lm, "elites": card.elite_indices.tolist(),
            "distinct_plans": plans, "losses_card": losses_card.tolist(),
            "losses_cpu": losses_cpu.tolist(), "loss_rel_dist": rel,
            "loss_delta_card": card.loss_delta.tolist(),
            "pareto_mask_card": card.pareto_mask.tolist(),
            "pareto_mask_cpu": cpu.pareto_mask.tolist(),
            "card_validate_s": card_s, "cpu_validate_s": cpu_s,
            "card_s_per_loss": card_s / (plans + 1),
            "cpu_s_per_loss": cpu_s / (plans + 1),
            "flash_launches": flash,
            "flash_launches_per_loss": flash / (plans + 1),
            "launches": launches})
        out[arch] = row
    return out


def _grads(model, params_cpu, batch_cpu, device):
    """(loss, leaves) of ``model``'s QAT loss on ``device``, every leaf
    of ``params_cpu`` a fresh tensor there that requires grad."""
    from repro_torch.models.tree import tree_map
    leaves = tree_map(lambda p: p.detach().to(device).requires_grad_(True),
                      params_cpu)
    loss = model.loss(leaves, {k: v.to(device)
                               for k, v in batch_cpu.items()})
    loss.backward()
    return float(loss.detach()), leaves


def phase_grad_guard(device) -> dict:
    """ROADMAP C.13: reduced phi4-mini (2 layers) under QAT (its w8a8
    policy, ``train=True``) and under fp32: no kernel launches while the
    loss is taken with grad, every leaf's gradient on the card within the
    bar of the CPU's (``GRAD_GUARD``, each leaf to its largest magnitude);
    the same model under ``torch.no_grad()`` launches flash once a
    layer."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.model import Model
    from repro_torch.models.tree import tree_map
    from repro_torch.optim.adamw import leaves as tree_leaves
    out = {"phase": "grad_guard", "arch": GRAD_GUARD["arch"]}
    base = reduced(get_config(GRAD_GUARD["arch"]))
    for mode, bar in GRAD_GUARD["bars"].items():
        cfg = dataclasses.replace(base, quant=mode)
        params = Model(cfg, device="cpu").init(
            torch.Generator("cpu").manual_seed(0))
        batch = SyntheticLM(DataConfig(cfg.vocab, GRAD_GUARD["seq_len"],
                                       GRAD_GUARD["batch"])).batch(0, "cpu")
        card_model = Model(cfg, device=device)
        _reset_attention_counts()
        _reset_matmul_counts()
        card_loss, card = _grads(card_model, params, batch, device)
        torch.cuda.synchronize(device)
        under_grad = {**_attention_counts(), **_matmul_counts()}
        check(not any(under_grad.values()),
              f"grad_guard {mode}: kernels launched under grad "
              f"{under_grad}")
        cpu_loss, cpu = _grads(Model(cfg, device="cpu"), params, batch,
                               "cpu")
        worst, missing = (0.0, ""), []
        for (path, a, _), (_, b, _) in zip(tree_leaves(card),
                                           tree_leaves(cpu)):
            if a.grad is None:
                missing.append(path)
                continue
            err = float((a.grad.cpu() - b.grad).abs().max()
                        / b.grad.abs().max().clamp_min(1e-30))
            worst = max(worst, (err, path))
        check(not missing, f"grad_guard {mode}: no gradient on {missing}")
        check(worst[0] <= bar, f"grad_guard {mode}: worst leaf {worst}")
        _reset_attention_counts()
        with torch.no_grad():
            card_model.loss(tree_map(lambda p: p.detach(), card),
                            {k: v.to(device) for k, v in batch.items()},
                            train=False)
        torch.cuda.synchronize(device)
        no_grad = _attention_counts()["flash_attention"]
        check(no_grad == cfg.n_layers,
              f"grad_guard {mode}: {no_grad} flash launches under no_grad "
              f"for {cfg.n_layers} layers")
        out[mode] = {"card_loss": card_loss, "cpu_loss": cpu_loss,
                     "loss_rel_dist": abs(card_loss - cpu_loss)
                     / abs(cpu_loss),
                     "worst_leaf": worst[1], "worst_leaf_rel": worst[0],
                     "bar": bar, "leaves": len(tree_leaves(card)),
                     "launches_under_grad": under_grad,
                     "flash_launches_under_no_grad": no_grad}
    return out


def _train_state(cfg, device, grad_compression: bool = False):
    """``launch.train``'s initial state: the CPU draw of seed 0 moved to
    ``device``, fresh AdamW moments, a zero error-feedback tree under
    ``grad_compression``."""
    import torch
    from repro_torch.models.model import Model
    from repro_torch.models.tree import tree_map
    from repro_torch.optim import adamw
    from repro_torch.parallel import compression
    params = tree_map(lambda p: p.to(device), Model(
        cfg, device="cpu").init(torch.Generator("cpu").manual_seed(0)))
    return {"params": params, "opt": adamw.init(params),
            "err": compression.init_error_state(params)
            if grad_compression else {}}


def phase_train(device) -> dict:
    """``launch.train.train`` of mamba2-130m at full width and depth (W8A8
    QAT, ``TRAIN`` batch x sequence and steps) on the card: the loss
    falls, no kernel launches, peak memory; then the same train step
    timed step by step on batches drawn ahead (host clock around
    synchronized steps, the profiler's device time per step; the draw of
    a batch timed apart), its first two losses on the CPU against the
    card's; then one QAT step of phi4-mini-3.8b at full width cut to 2
    layers, loss and global gradient norm card vs CPU."""
    import statistics
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.train import make_train_step, train
    from repro_torch.models.model import Model
    from repro_torch.models.tree import tree_map
    from repro_torch.optim import adamw
    T = TRAIN
    out = {"phase": "train", "arch": T["arch"], "batch": T["batch"],
           "seq_len": T["seq_len"], "steps": T["steps"]}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    _reset_attention_counts()
    _reset_matmul_counts()
    t0 = time.perf_counter()
    losses = train(T["arch"], steps=T["steps"], smoke=False,
                   seq_len=T["seq_len"], batch=T["batch"],
                   log_every=T["steps"], device=device)
    torch.cuda.synchronize(device)
    out["train_s"] = time.perf_counter() - t0
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated(device)
    out["launches"] = {**_attention_counts(), **_matmul_counts()}
    out["losses"] = [l for _, l in losses]
    check(not any(out["launches"].values()),
          f"train: kernels launched {out['launches']}")
    check(all(math.isfinite(l) for l in out["losses"])
          and out["losses"][-1] < out["losses"][0],
          f"train: loss did not fall {out['losses']}")

    cfg = get_config(T["arch"])
    model = Model(cfg, device=device)
    ocfg = adamw.AdamWConfig(lr=3e-3, total_steps=T["steps"],
                             warmup_steps=max(1, T["steps"] // 10))
    step_fn = make_train_step(model, None, ocfg)
    # train()'s data and draw: seed 0; the batches drawn ahead, timed
    # (the host's numpy draw over the vocabulary, a part of each step of
    # train())
    data = SyntheticLM(DataConfig(cfg.vocab, T["seq_len"], T["batch"],
                                  seed=0))
    t0 = time.perf_counter()
    batches = [data.batch(s, device=device) for s in range(T["timed"] + 3)]
    out["synthetic_batch_s"] = (time.perf_counter() - t0) / len(batches)
    state = {"s": _train_state(cfg, device)}

    def step(i):
        state["s"], loss = step_fn(state["s"], batches[i % len(batches)])
        return loss
    step(0)
    times = []
    for i in range(1, T["timed"] + 1):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        step(i)
        torch.cuda.synchronize(device)
        times.append(time.perf_counter() - t0)
    step_s = statistics.median(times)
    device_ms, top, ops, kept = _profile_device_ms(step, BUSY_STEPS)
    out.update(step_ms=step_s * 1e3, step_ms_all=[t * 1e3 for t in times],
               tokens_per_s=T["batch"] * T["seq_len"] / step_s,
               device_ms_per_step=device_ms,
               device_busy_share=(device_ms / (step_s * 1e3)
                                  if device_ms else None),
               device_ops_per_step=ops, profiler_records_kept=kept,
               top_device_ops=top)
    del state, batches
    torch.cuda.empty_cache()

    cpu_model = Model(cfg, device="cpu")
    cpu_step = make_train_step(cpu_model, None, ocfg)
    cpu_state = _train_state(cfg, "cpu")
    t0 = time.perf_counter()
    cpu_losses = []
    for s in range(2):
        cpu_state, loss = cpu_step(cpu_state, data.batch(s, device="cpu"))
        cpu_losses.append(float(loss))
    out["cpu_step_s"] = (time.perf_counter() - t0) / 2
    rel = [abs(a - b) / abs(b) for a, b in zip(out["losses"], cpu_losses)]
    out.update(cpu_losses=cpu_losses, loss_rel_dist=rel)
    check(max(rel) <= T["loss_rtol"],
          f"train: first losses card {out['losses'][:2]} vs CPU "
          f"{cpu_losses}")
    del cpu_state

    # attention under grad at full width: phi4-mini cut to 2 layers
    import dataclasses
    pcfg = dataclasses.replace(get_config(T["attention_arch"]),
                               n_layers=T["attention_layers"])
    params = Model(pcfg, device="cpu").init(
        torch.Generator("cpu").manual_seed(0))
    batch = SyntheticLM(DataConfig(pcfg.vocab, T["seq_len"],
                                   T["attention_batch"])).batch(0, "cpu")
    row = {"arch": T["attention_arch"], "n_layers": pcfg.n_layers,
           "batch": T["attention_batch"], "seq_len": T["seq_len"]}
    _reset_attention_counts()
    _reset_matmul_counts()
    torch.cuda.reset_peak_memory_stats(device)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    card_loss, card = _grads(Model(pcfg, device=device), params, batch,
                             device)
    card_norm = float(adamw.global_norm(
        tree_map(lambda p: p.grad, card)))
    torch.cuda.synchronize(device)
    row["card_s"] = time.perf_counter() - t0
    row["peak_memory_bytes"] = torch.cuda.max_memory_allocated(device)
    row["launches"] = {**_attention_counts(), **_matmul_counts()}
    del card
    t0 = time.perf_counter()
    cpu_loss, cpu = _grads(Model(pcfg, device="cpu"), params, batch, "cpu")
    cpu_norm = float(adamw.global_norm(
        tree_map(lambda p: p.grad, cpu)))
    row["cpu_s"] = time.perf_counter() - t0
    del cpu, params
    row.update(card_loss=card_loss, cpu_loss=cpu_loss,
               loss_rel_dist=abs(card_loss - cpu_loss) / abs(cpu_loss),
               card_grad_norm=card_norm, cpu_grad_norm=cpu_norm,
               grad_norm_rel_dist=abs(card_norm - cpu_norm) / cpu_norm)
    check(not any(row["launches"].values()),
          f"train {T['attention_arch']}: kernels under grad "
          f"{row['launches']}")
    check(row["loss_rel_dist"] <= T["loss_rtol"]
          and row["grad_norm_rel_dist"] <= T["norm_rtol"],
          f"train {T['attention_arch']}: card vs CPU {row}")
    out["attention_step"] = row
    return out


def _checkpoint_digest(ckpt_dir: str, step: int) -> tuple:
    """``(step, sha256 of arrays.npz)`` from a checkpoint's ``meta.json``:
    ``np.savez`` writes equal trees to equal bytes."""
    with open(pathlib.Path(ckpt_dir, f"step_{step:08d}", "meta.json")) as f:
        meta = json.load(f)
    return meta["step"], meta["sha256"]


def _leaves_differ(a, b) -> dict:
    """Leaves of two trees of one structure that differ: count, the
    largest absolute difference, the first few paths by index."""
    import torch
    from repro_torch.models.tree import tree_flatten
    la, da = tree_flatten(a)
    lb, db = tree_flatten(b)
    check(str(da) == str(db), "train_restart: the two states' structures")
    bad, worst = [], 0.0
    for i, (x, y) in enumerate(zip(la, lb)):
        same = torch.equal(x, y) if torch.is_tensor(x) else x == y
        if not same:
            bad.append(i)
            if torch.is_tensor(x):
                worst = max(worst, float((x.double() - y.double())
                                         .abs().max()))
    return {"leaves": len(la), "differ": len(bad), "first": bad[:8],
            "max_abs": worst}


def _moved(tree, device):
    """``tree`` with every tensor leaf on ``device``."""
    import torch
    from repro_torch.models.tree import tree_flatten
    leaves, treedef = tree_flatten(tree)
    return treedef.unflatten([t.to(device) if torch.is_tensor(t) else t
                              for t in leaves])


def phase_train_restart(device) -> dict:
    """The rest of the training stack at full width: ``launch.train.train``
    of mamba2-130m (W8A8 QAT, ``TRAIN_RESTART`` batch x sequence) with int8
    gradient compression and a checkpoint every 3 steps, once clean and
    once with two injected failures: the restarts counted, every loss of
    a step and the final checkpoint (params, AdamW's ``mu``, ``nu``,
    ``step``, the error feedback) byte for byte (its sha256; where the
    bytes differ, the leaves that differ), no kernel launch.  The clean
    run's step-2 checkpoint restored on the card and on the CPU and
    stepped once on each (the card's equal to the clean run's step 3, the
    CPU's within the loss bar); the checkpoint's bytes, save and
    restore times; ``compress_grads`` of one full-width gradient tree on
    the card and the CPU bit for bit; the compressed step's own time; the
    ops deterministic mode names in a compressed step; the step with and
    without compression in turns (host clock, CUDA events,
    profiler device time, and the host time around the call before
    ``float(loss)`` waits, which with the batch's draw is what the
    straggler detector reads)."""
    import contextlib
    import io
    import os
    import shutil
    import statistics
    import tempfile
    import warnings
    import torch
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.train import make_train_step, train
    from repro_torch.models.model import Model
    from repro_torch.models.tree import tree_map
    from repro_torch.optim import adamw
    from repro_torch.parallel import compression
    T = TRAIN_RESTART
    out = {"phase": "train_restart", "arch": T["arch"], "batch": T["batch"],
           "seq_len": T["seq_len"], "steps": T["steps"],
           "ckpt_every": T["ckpt_every"],
           "fail_at": {str(k): v for k, v in T["fail_at"].items()}}
    cfg = get_config(T["arch"])
    last = T["steps"] - 1
    kw = dict(steps=T["steps"], smoke=False, seq_len=T["seq_len"],
              batch=T["batch"], ckpt_every=T["ckpt_every"],
              grad_compression=True, log_every=T["steps"], device=device)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    _reset_attention_counts()
    _reset_matmul_counts()
    like_cpu = _train_state(cfg, "cpu", grad_compression=True)

    def run(ckpt_dir, fail_at=None) -> dict:
        printed = io.StringIO()
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            losses = train(T["arch"], ckpt_dir=ckpt_dir, fail_at=fail_at,
                           **kw)
        torch.cuda.synchronize(device)
        seconds = time.perf_counter() - t0
        text = printed.getvalue()
        print(text, end="", flush=True)
        tail = text.rsplit("restarts=", 1)[1].split()
        return {"losses": losses, "train_s": seconds,
                "restarts": int(tail[0]),
                "stragglers": int(tail[1].split("=")[1])}

    with tempfile.TemporaryDirectory() as root:
        clean_dir = os.path.join(root, "clean")
        clean = run(clean_dir)
        out["clean"] = {k: clean[k] for k in ("train_s", "restarts",
                                              "stragglers")}
        out["losses"] = [l for _, l in clean["losses"]]
        check(clean["restarts"] == 0
              and [s for s, _ in clean["losses"]] == list(range(T["steps"])),
              f"train_restart: the clean run {clean['losses']}")
        check(sorted(os.listdir(clean_dir)) == [
            f"step_{s:08d}" for s in range(T["steps"])
            if (s + 1) % T["ckpt_every"] == 0 or s == last][-3:],
            f"train_restart: checkpoints {os.listdir(clean_dir)}")
        npz = os.path.join(clean_dir, f"step_{last:08d}", "arrays.npz")
        out["checkpoint_bytes"] = os.path.getsize(npz)
        clean_final = _checkpoint_digest(clean_dir, last)

        # the elastic case: the card's step-2 checkpoint on both devices
        e = T["elastic_step"]
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        card_state = ckpt.restore(clean_dir, e, _moved(like_cpu, device))
        torch.cuda.synchronize(device)
        out["restore_to_card_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu_state = ckpt.restore(clean_dir, e, like_cpu)
        out["restore_to_cpu_s"] = time.perf_counter() - t0
        ocfg = adamw.AdamWConfig(lr=3e-3, total_steps=T["steps"],
                                 warmup_steps=max(1, T["steps"] // 10))
        data = SyntheticLM(DataConfig(cfg.vocab, T["seq_len"], T["batch"],
                                      seed=0))
        batch = data.batch(e + 1, device="cpu")
        card_step = make_train_step(Model(cfg, device=device), None,
                                    ocfg, grad_compression=True)
        card_state, card_loss = card_step(
            card_state, {k: v.to(device) for k, v in batch.items()})
        card_loss = float(card_loss)
        t0 = time.perf_counter()
        _, cpu_loss = make_train_step(
            Model(cfg, device="cpu"), None, ocfg,
            grad_compression=True)(cpu_state, batch)
        out["cpu_step_s"] = time.perf_counter() - t0
        cpu_loss = float(cpu_loss)
        del cpu_state
        want = dict(clean["losses"])[e + 1]
        out["elastic"] = {
            "restored_step": e, "card_loss": card_loss,
            "cpu_loss": cpu_loss, "clean_run_loss": want,
            "card_vs_clean_equal": card_loss == want,
            "cpu_vs_card_rel": abs(cpu_loss - card_loss) / abs(card_loss)}
        check(card_loss == want,
              f"train_restart: step {e + 1} from the restored checkpoint "
              f"{card_loss} vs the clean run's {want}")
        check(out["elastic"]["cpu_vs_card_rel"] <= T["loss_rtol"],
              f"train_restart: the CPU's step {e + 1} {out['elastic']}")
        # one save of a full state, timed
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        ckpt.save(os.path.join(root, "timed"), e + 1, card_state)
        out["save_s"] = time.perf_counter() - t0
        del card_state
        shutil.rmtree(os.path.join(root, "timed"))

        faulty_dir = os.path.join(root, "faulty")
        faulty = run(faulty_dir, dict(T["fail_at"]))
        out["faulty"] = {k: faulty[k] for k in ("train_s", "restarts",
                                                "stragglers")}
        out["faulty"]["steps"] = [s for s, _ in faulty["losses"]]
        # the final states: equal checkpoint bytes are equal leaves; where
        # the bytes differ, the leaves that differ
        faulty_final = _checkpoint_digest(faulty_dir, last)
        out["final_state"] = {"sha256_equal": faulty_final == clean_final,
                              "step": faulty_final[0]}
        if faulty_final != clean_final:
            out["final_state"].update(_leaves_differ(
                ckpt.restore(faulty_dir, last, like_cpu),
                ckpt.restore(clean_dir, last, like_cpu)))
    out["launches"] = {**_attention_counts(), **_matmul_counts()}
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated(device)
    check(faulty["restarts"] == sum(T["fail_at"].values()),
          f"train_restart: {faulty['restarts']} restarts")
    out["final_loss_equal"] = faulty["losses"][-1] == clean["losses"][-1]
    out["losses_equal"] = dict(faulty["losses"]) == dict(clean["losses"])
    check(out["final_loss_equal"] and out["losses_equal"],
          f"train_restart: losses {faulty['losses']} vs {clean['losses']}")
    check(out["final_state"]["sha256_equal"]
          and faulty_final[0] == clean_final[0] == last,
          f"train_restart: final state {out['final_state']}")
    check(not any(out["launches"].values()),
          f"train_restart: kernels launched {out['launches']}")
    del like_cpu

    # compress_grads of one full-width gradient tree, card vs CPU
    params_cpu = _train_state(cfg, "cpu")["params"]
    batch = data.batch(0, device="cpu")
    _, leaves = _grads(Model(cfg, device=device), params_cpu, batch, device)
    g_card = tree_map(lambda p: p.grad, leaves)
    g_cpu = _moved(g_card, "cpu")
    del leaves
    rounds, e_card, e_cpu = [], compression.init_error_state(g_card), \
        compression.init_error_state(g_cpu)
    for r in range(2):
        q_card, s_card, e_card = compression.compress_grads(g_card, e_card)
        q_cpu, s_cpu, e_cpu = compression.compress_grads(g_cpu, e_cpu)
        rounds.append({name: _leaves_differ(_moved(a, "cpu"), b)
                       for name, a, b in (("codes", q_card, q_cpu),
                                          ("scales", s_card, s_cpu),
                                          ("err", e_card, e_cpu))})
    out["compress_card_vs_cpu"] = rounds
    check(all(v["differ"] == 0 for r in rounds for v in r.values()),
          f"train_restart: compression card vs CPU {rounds}")
    out["compress_roundtrip_ms"] = _event_ms(
        lambda: compression.compress_roundtrip(g_card, e_card), 5, 2)
    t0 = time.perf_counter()
    compression.compress_roundtrip(g_cpu, e_cpu)
    out["compress_roundtrip_cpu_ms"] = (time.perf_counter() - t0) * 1e3
    del g_card, g_cpu, e_card, e_cpu, q_card, q_cpu, s_card, s_cpu

    # the step with and without compression, in turns
    model = Model(cfg, device=device)
    batches = [data.batch(s, device=device) for s in range(T["timed"] + 1)]
    # deterministic mode: the ops it names in a compressed step, its loss
    step_fn = make_train_step(model, None, ocfg, grad_compression=True)
    state = _train_state(cfg, device, grad_compression=True)
    loss = float(step_fn(state, batches[0])[1])
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            det_loss = float(step_fn(state, batches[0])[1])
    finally:
        torch.use_deterministic_algorithms(False)
    out["deterministic_mode"] = {
        "warnings": sorted({str(w.message)[:160] for w in caught}),
        "loss_equal": det_loss == loss}
    del state
    timing = {}
    for comp in (False, True, True, False):
        step_fn = make_train_step(model, None, ocfg, grad_compression=comp)
        state = {"s": _train_state(cfg, device, grad_compression=comp)}

        def step(i):
            state["s"], loss = step_fn(state["s"], batches[i % len(batches)])
            return loss
        step(0)
        host, call, event = [], [], []
        for i in range(1, T["timed"] + 1):
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            loss = step(i)
            call.append(time.perf_counter() - t0)
            end.record()
            float(loss)
            torch.cuda.synchronize(device)
            host.append(time.perf_counter() - t0)
            event.append(start.elapsed_time(end))
        device_ms, top, ops, kept = _profile_device_ms(step, BUSY_STEPS)
        row = timing.setdefault("compressed" if comp else "plain", [])
        row.append({"step_ms": statistics.median(host) * 1e3,
                    "event_ms": statistics.median(event),
                    # what the straggler detector reads, less the draw of
                    # the batch: the host's clock around the call, before
                    # float(loss) waits for the card
                    "call_host_ms": statistics.median(call) * 1e3,
                    "device_ms_per_step": device_ms,
                    "device_busy_share": (
                        device_ms / (statistics.median(host) * 1e3)
                        if device_ms else None),
                    "device_ops_per_step": ops,
                    "profiler_records_kept": kept, "top_device_ops": top})
        del state
    out["step_timing"] = timing
    out["step_ms"] = {k: min(r["step_ms"] for r in v)
                      for k, v in timing.items()}
    del batches, model
    torch.cuda.empty_cache()
    return out


def _mesh_grid():
    """(b)'s sweep: the 102,960-config grid of ``phase_parity`` in one
    batch, its synthesis, and each config's own PE type on every layer of
    VGG-16, ResNet-34 and ResNet-50 (W = 3)."""
    import numpy as np
    from repro_torch.core.synthesis import synthesize_soa
    from repro_torch.core.workloads import get_workload
    chunks = list(grid(GRID_FULL))
    soa = {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}
    wls = tuple(get_workload(w) for w in TIMING_W3)
    assigns = [np.repeat(soa["pe_type_idx"][:, None], len(w.layers), axis=1)
               for w in wls]
    return wls, soa, synthesize_soa(soa), assigns


def _rows(tree: dict, n: int) -> dict:
    return {k: v[:n] for k, v in tree.items()}


def _same_arrays(a: dict, b: dict) -> bool:
    import numpy as np
    return set(a) == set(b) and all(
        np.asarray(a[k]).shape == np.asarray(b[k]).shape
        and np.array_equal(a[k], b[k]) for k in a)


def mesh_child(rank: int, tmp: str, device_type: str = "cuda") -> int:
    """One of the mesh phase's 4 gloo ranks on the card: (b)'s sharded
    sweep through the kernel, expert parallelism on a moonshot layer at
    full width, and a reshard of a train state; writes its row to
    ``tmp/rank{rank}.json``.  ``device_type="cpu"`` rehearses it on the
    host (the sweep's exact path, no kernel)."""
    import traceback
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core.dse_batch import AGGREGATE_OUTPUTS
    from repro_torch.core.dse_batch import _sweep_mixed_many
    from repro_torch.kernels import sweep_kernel
    from repro_torch.launch.mesh import make_sweep_mesh
    out = {"rank": rank}
    dist.init_process_group("gloo", init_method=f"file://{tmp}/init",
                            rank=rank, world_size=MESH["world"])
    if device_type == "cuda":
        torch.cuda.set_device(0)
    device = torch.device("cuda", 0) if device_type == "cuda" \
        else torch.device("cpu")
    try:
        t0 = time.perf_counter()
        wls, soa, cols, assigns = _mesh_grid()
        z = np.load(f"{tmp}/want.npz")
        n_full = len(soa["pe_rows"])
        mesh = make_sweep_mesh(device_type=device_type)
        sweep_kernel.launches = 0
        out["sweep"] = {}
        for n in (n_full, n_full - MESH["pad"]):
            got = _sweep_mixed_many(wls, _rows(soa, n),
                                    [a[:n] for a in assigns],
                                    cols=_rows(cols, n), device=device,
                                    mesh=mesh)
            want = {k: z[f"{n}/{k}"] for k in AGGREGATE_OUTPUTS}
            out["sweep"][str(n)] = {
                "bit_for_bit": _same_arrays(
                    {k: got[k] for k in AGGREGATE_OUTPUTS}, want),
                "differing": {k: int(np.sum(got[k] != want[k]))
                              for k in AGGREGATE_OUTPUTS
                              if got[k].shape == want[k].shape},
                "pad": -n % MESH["world"],
                "local_rows": -(-n // MESH["world"])}
        out["sweep_launches"] = sweep_kernel.launches
        out["sweep_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["ep"] = _mesh_child_ep(device)
        out["ep_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["reshard"] = _mesh_child_reshard()
        out["reshard_s"] = time.perf_counter() - t0
    except Exception:
        out["error"] = traceback.format_exc()[-3000:]
    finally:
        with open(f"{tmp}/rank{rank}.json", "w") as f:
            json.dump(out, f)
        if "error" not in out:
            dist.barrier()
        dist.destroy_process_group()
    return 0 if "error" not in out else 1


def _mesh_child_ep(device) -> dict:
    """``moe_ffn_ep`` on one moonshot MoE layer at full width (64
    experts, top-6, d 2048), W8A8's bf16 compute, on the meshes (1, 4)
    and (2, 2): against ``moe_ffn`` on each data slice alone (at (1, 4)
    the whole batch), aux against the slices' mean."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import device_mesh
    from repro_torch.models import moe
    from repro_torch.models.model import Model
    from repro_torch.parallel.sharding import (activation_sharding,
                                               default_activation_rules)
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=1)
    model = Model(cfg, device=device)
    gen = torch.Generator(device).manual_seed(0)
    lp = model.init(gen)["layers"][0]
    ep = MESH["ep"]
    x = torch.randn((ep["batch"], ep["seq"], cfg.d_model), generator=gen,
                    device=device).to(model.policy.compute_dtype)
    rows = {}
    for shape in ep["meshes"]:
        mesh = device_mesh(device.type, torch.arange(MESH["world"])
                           .reshape(shape), ("data", "model"))
        with activation_sharding(mesh, default_activation_rules(
                mesh, seq_sharded=False)):
            y, aux = moe.moe_ffn_ep(x, lp, cfg, policy=model.policy,
                                    train=False)
        parts = [moe.moe_ffn(xs, lp, cfg, policy=model.policy, train=False)
                 for xs in x.chunk(shape[0])]
        want = torch.cat([p[0] for p in parts]).float()
        want_aux = float(sum(p[1] for p in parts)) / shape[0]
        err = (y.float() - want).abs()
        scale = float(want.abs().max())
        ulp = 2.0 ** (math.floor(math.log2(scale)) - 7)
        rows[f"{shape[0]}x{shape[1]}"] = {
            "experts_local": cfg.n_experts // shape[1],
            "tokens_local": ep["batch"] * ep["seq"] // shape[0],
            "within_tol": bool((err <= ep["tol"] * (1 + want.abs()))
                               .all()),
            "max_abs_err": float(err.max()), "scale": scale,
            "max_err_scale_ulps": float(err.max()) / ulp,
            "equal_elements": float((err == 0).float().mean()),
            "aux": float(aux), "aux_err": abs(float(aux) - want_aux),
            "finite": bool(torch.isfinite(y).all())}
    return rows


def _mesh_child_reshard() -> dict:
    """A train state (reduced mamba2-130m: params and AdamW moments) on
    host meshes of the 4 ranks: (4, 1), then (2, 2), then
    ``survivable_mesh`` of ranks 0-2; every leaf's ``full_tensor()``
    against the state after each step.  On the host: a ``DTensor`` of
    CUDA tensors over gloo ends the process (SIGSEGV, torch 2.11)."""
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced
    from repro_torch.launch.mesh import device_mesh
    from repro_torch.models.model import Model
    from repro_torch.models.tree import tree_flatten
    from repro_torch.optim import adamw
    from repro_torch.runtime.elastic import reshard, survivable_mesh
    cfg = reduced(get_config(MESH["reshard_arch"]))
    params = Model(cfg, device="cpu").init(
        torch.Generator("cpu").manual_seed(0))
    state = {"params": params, "opt": adamw.init(params)}
    leaves, _ = tree_flatten(state)
    names = ("data", "model")
    meshes = {"4x1": device_mesh("cpu", torch.arange(4).reshape(4, 1), names),
              "2x2": device_mesh("cpu", torch.arange(4).reshape(2, 2), names)}
    meshes["survivable_3"] = survivable_mesh([0, 1, 2], device_type="cpu")
    rows = {"survivable_3_shape": list(meshes["survivable_3"].shape),
            "survivable_shapes": {k: list(survivable_mesh(
                list(range(k)), device_type="cpu").shape) for k in (4, 3, 2)}}
    cur = state
    for name, mesh in meshes.items():
        cur = reshard(cur, mesh)
        got, _ = tree_flatten(cur)
        inside = mesh.get_coordinate() is not None
        same = n = 0
        for a, b in zip(leaves, got):
            if isinstance(a, torch.Tensor):
                n += 1
                same += int(isinstance(b, DTensor) and (
                    not inside or torch.equal(b.full_tensor(), a)))
        rows[name] = {"leaves": n, "bit_for_bit": same == n,
                      "in_mesh": inside}
    return rows


def phase_mesh(device) -> dict:
    """Placement across ranks on the card.  (a) A one-rank NCCL mesh
    (``make_sweep_mesh()``): the 720-point VGG-16 sweep (points and
    aggregates), ``.many`` of the three workloads, the chunked stream over
    the 102,960-config grid and a ``many-quick`` nsga2 search, each bit
    for bit the same call without ``mesh`` (the sweep kernel's launches
    counted over the mesh runs); the group destroyed after.  (b) 4 gloo
    ranks on the card, this script's children (``--mesh-child``): each
    sweeps its slice of the grid at W = 3 with the kernel (and of the
    grid less one row: one padded row), gathered bit for bit the one-launch
    result; ``moe_ffn_ep`` on a moonshot layer at full width on (1, 4) and
    (2, 2); ``reshard`` of a train state (4, 1) -> (2, 2) -> 3 ranks."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        return _phase_mesh(device, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _phase_mesh(device, tmp: str) -> dict:
    import os
    import numpy as np
    from repro_torch.core.dse import ExploreSpec, run
    from repro_torch.core.dse_batch import (AGGREGATE_OUTPUTS,
                                            _sweep_mixed_many)
    from repro_torch.kernels import sweep_kernel
    from repro_torch.launch.mesh import make_sweep_mesh, release_process_group

    out = {"phase": "mesh"}
    t0 = time.perf_counter()
    wls, soa, cols, assigns = _mesh_grid()
    n_full = len(soa["pe_rows"])
    want = {}
    for n in (n_full, n_full - MESH["pad"]):
        got = _sweep_mixed_many(wls, _rows(soa, n), [a[:n] for a in assigns],
                                cols=_rows(cols, n), device=device)
        want.update({f"{n}/{k}": got[k] for k in AGGREGATE_OUTPUTS})
    np.savez(f"{tmp}/want.npz", **want)
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                               MESH_CHILD_FLAG, str(r), tmp])
             for r in range(MESH["world"])]
    try:
        t1 = time.perf_counter()
        mesh = make_sweep_mesh()
        check(mesh.size() == 1 and mesh.device_type == device.type,
              "one-rank mesh on the card")
        out["backend"] = __import__("torch").distributed.get_backend()
        calls = {
            "single_points": lambda m: run(ExploreSpec.single(
                "vgg16", outputs="sweep", mesh=m), device=device).arrays,
            "single_aggregates": lambda m: run(ExploreSpec.single(
                "vgg16", outputs="aggregates", mesh=m),
                device=device).arrays,
            "many_w3": lambda m: {
                f"{w}/{k}": v for w, r in run(ExploreSpec.many(
                    TIMING_W3, outputs="aggregates", mesh=m),
                    device=device).items() for k, v in r.arrays.items()},
            "stream": lambda m: _stream_arrays(run(ExploreSpec.single(
                "vgg16", grid(GRID_FULL), chunk_size=CHUNK, mesh=m),
                device=device)),
            "search": lambda m: _search_arrays(run(ExploreSpec.many(
                TIMING_W3, precision="mixed", mesh=m, **MESH["search"]),
                device=device))}
        plain = {name: fn(None) for name, fn in calls.items()}
        sweep_kernel.launches = 0
        sharded = {name: fn(mesh) for name, fn in calls.items()}
        out["one_rank_launches"] = sweep_kernel.launches
        shards = {k: int(v.pop("mesh_shards")) for k, v in (
            ("plain", plain["search"]), ("mesh", sharded["search"]))}
        out["one_rank"] = {name: _same_arrays(sharded[name], plain[name])
                           for name in calls}
        out["one_rank_mesh_shards"] = shards["mesh"]
        check(shards["plain"] == -1, "search without a mesh: mesh_shards")
        out["one_rank_s"] = time.perf_counter() - t1
        release_process_group()
        check(not __import__("torch").distributed.is_initialized(),
              "the one-rank group is destroyed")
        for name, same in out["one_rank"].items():
            check(same, f"one-rank mesh {name} differs from no mesh")
        check(out["one_rank_mesh_shards"] == 1, "search mesh_shards")
        check(device.type != "cuda"       # a host rehearsal launches none
              or out["one_rank_launches"] >= 1 + len(TIMING_W3) + 4,
              f"sweep kernel launches on the mesh runs "
              f"{out['one_rank_launches']}")
        deadline = time.monotonic() + MESH["timeout_s"]
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ranks = []
    for r in range(MESH["world"]):
        path = f"{tmp}/rank{r}.json"
        check(os.path.exists(path), f"mesh child {r} wrote no row")
        with open(path) as f:
            ranks.append(json.load(f))
    for r, row in enumerate(ranks):
        check("error" not in row, f"mesh child {r}: {row.get('error')}")
        check(procs[r].returncode == 0, f"mesh child {r} exit code")
        for n, res in row["sweep"].items():
            check(res["bit_for_bit"],
                  f"rank {r}: sharded sweep of {n} configs differs from "
                  f"the one-launch result")
        check(device.type != "cuda" or row["sweep_launches"] == 2,
              f"rank {r}: {row['sweep_launches']} sweep launches, not 2")
        for shape, ep in row["ep"].items():
            check(ep["within_tol"] and ep["finite"],
                  f"rank {r}: moe_ffn_ep {shape} beyond the bf16 bar")
            check(ep["aux_err"] <= 1e-6, f"rank {r}: moe_ffn_ep {shape} aux")
        rs = row["reshard"]
        for name in ("4x1", "2x2", "survivable_3"):
            check(rs[name]["bit_for_bit"], f"rank {r}: reshard {name}")
        check(rs["survivable_3_shape"] == [3, 1], "survivable mesh of 3")
        check(rs["survivable_shapes"] == {"4": [1, 4], "3": [3, 1],
                                          "2": [1, 2]},
              "survivable mesh shapes")
    out["four_ranks"] = {
        "sweep": ranks[0]["sweep"],
        "sweep_launches_by_rank": [row["sweep_launches"] for row in ranks],
        "ep": ranks[0]["ep"], "reshard": ranks[0]["reshard"],
        "seconds_by_rank": [{k: row[k] for k in ("sweep_s", "ep_s",
                                                 "reshard_s")}
                            for row in ranks],
        "collectives": "gloo: sweep all_gather and EP all_reduce / "
                       "all_gather staged through host memory; reshard's "
                       "DTensor collectives on host tensors"}
    out["seconds"] = time.perf_counter() - t0
    return out


def _stream_arrays(res) -> dict:
    import numpy as np
    return {"n": np.array([res.n_configs, res.n_chunks]),
            **{f"soa/{k}": v for k, v in res.front_soa.items()},
            **{f"metrics/{k}": v for k, v in res.front_metrics.items()}}


def _search_arrays(res) -> dict:
    import numpy as np
    shards = res.stats["mesh_shards"]
    return {"genomes": res.genomes, "front": res.front_objectives,
            "mesh_shards": np.array(-1 if shards is None else shards)}


def phase_roofline(device) -> dict:
    """The port's roofline of whole steps (``launch/dryrun.run_cell(...,
    measure=True)``) on the ``ROOFLINE`` cells: each cell dry-run under
    fake tensors at full width and depth, then built on the card and
    counted again with the kernels launching (the two counts equal field
    by field, every kernel call of the count a launch), then timed (CUDA
    events; profiler device time, the largest of three windows).  Prints
    each cell's roofline step time, measured step, ``measured_fraction``
    and the count's argument + temp bytes beside the peak the card
    allocated.  The W8A8 cells share one draw of the params, freed before
    the W4A8 cell draws its own."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.models.model import Model
    arch = ROOFLINE["arch"]
    _reset_matmul_counts()
    _reset_attention_counts()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    shared = Model(get_config(arch), device=device).init(
        torch.Generator(device).manual_seed(0), quantize=True)
    torch.cuda.synchronize(device)
    draw_s = time.perf_counter() - t0
    cells, kernels_seen = [], set()
    for shape, kw in ROOFLINE["cells"]:
        if kw.get("mode"):      # another mode draws its own params
            shared = None
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        rec = dryrun.run_cell(arch, shape, measure=True, device=device,
                              out_dir=None, params=shared, **kw)
        check(rec["status"] == "ok", f"roofline {arch} {shape} {kw}: "
                                     f"{rec.get('error')}")
        m, r, mem = rec["measured"], rec["roofline"], rec["memory_analysis"]
        by_kernel = rec["stats"]["by_kernel"]
        check(m["card_count_equal"],
              f"roofline {shape} {kw}: the card's count differs from the "
              f"dry run's: {m['card_stats']} vs {rec['stats']}")
        for name, k in by_kernel.items():
            check(m["kernel_launches"][name] == k["calls"] > 0,
                  f"roofline {shape} {kw}: {k['calls']} {name} calls "
                  f"counted, {m['kernel_launches'][name]} launched")
            kernels_seen.add(name)
        row = {"shape": shape, **{k: v for k, v in kw.items()},
               "bottleneck": r["bottleneck"],
               "roofline_step_s": r["step_time_s"],
               "compute_s": r["compute_s"], "memory_s": r["memory_s"],
               "measured_s": m["measured_s"],
               "measured_fraction": m["measured_fraction"],
               "device_s": m["device_s"],
               "device_fraction": m["device_fraction"],
               "device_busy_share": m["device_busy_share"],
               "roofline_fraction": r["roofline_fraction"],
               "useful_flops_ratio": r["useful_flops_ratio"],
               "flops_by_class": r["flops_by_class"],
               "bytes_accessed": rec["stats"]["bytes_accessed"],
               "by_kernel": by_kernel,
               "argument_bytes": mem["argument_bytes"],
               "temp_bytes_estimate": mem["temp_bytes"],
               "argument_plus_temp_bytes":
                   mem["argument_bytes"] + mem["temp_bytes"],
               "peak_allocated_bytes": m["peak_allocated_bytes"],
               "peak_temp_allocated_bytes": m["peak_temp_allocated_bytes"],
               "kernel_launches": m["kernel_launches"],
               "dry_run_s": rec["compile_s"],
               "card_count_s": m["card_count_s"],
               "timing_s": m["timing_s"],
               "cell_s": time.perf_counter() - t0}
        cells.append(row)
        print(f"roofline {arch} {shape} {kw}: bound {r['step_time_s']:.6g} "
              f"s ({r['bottleneck']}), measured {m['measured_s']:.6g} s, "
              f"measured_fraction {m['measured_fraction']:.4g}, device "
              f"{m['device_s']} s; argument + temp bytes "
              f"{row['argument_plus_temp_bytes']} vs peak allocated "
              f"{m['peak_allocated_bytes']}", flush=True)
    torch.cuda.empty_cache()
    want = {"w8a8_matmul", "w4a8_matmul", "w8a8_decode_attention",
            "flash_attention"}
    check(kernels_seen == want, f"roofline: kernels under the counter "
                                f"{sorted(kernels_seen)}")
    return {"phase": "roofline", "arch": arch, "w8a8_draw_s": draw_s,
            "cells": cells,
            "launches": {**_attention_counts(), **_matmul_counts()}}


def _pod_options(kw: dict) -> dict:
    return {**dict(serve_quant=False, kv_quant=False, bf16_params=False,
                   weight_only_qat=False, mode=None, microbatch=1), **kw}


def pod_child(tmp: str) -> int:
    """The pod_count phase's child: each ``POD_COUNT["pods"]`` cell's
    sharded step counted on one card of a fake-group pod mesh (host work
    on fake tensors, nothing on the card); writes ``tmp/pod.json``."""
    import torch
    from repro_torch.launch import dryrun
    torch.set_num_threads(1)
    rows = []
    for shape, kw, multi_pod, kvs in POD_COUNT["pods"]:
        t0 = time.perf_counter()
        rec = dryrun.run_pod_cell(POD_COUNT["arch"], shape, out_dir=None,
                                  multi_pod=multi_pod, kv_seq_shard=kvs,
                                  count=True, **_pod_options(kw))
        row = {"shape": shape, **kw, "mesh": rec["mesh"],
               "kv_seq_shard": kvs, "status": rec["status"],
               "torch": torch.__version__,
               "seconds": time.perf_counter() - t0}
        if rec["status"] == "ok":
            r, st = rec["roofline"], rec["stats"]
            mem = rec["memory_analysis"]
            row.update(chips=rec["chips"], bottleneck=r["bottleneck"],
                       step_time_s=r["step_time_s"],
                       compute_s=r["compute_s"], memory_s=r["memory_s"],
                       collective_s=r["collective_s"],
                       flops_by_class=st["flops_by_class"],
                       bytes_accessed=st["bytes_accessed"],
                       collective_bytes_by_kind=st[
                           "collective_bytes_by_kind"],
                       collective_count_by_kind=st[
                           "collective_count_by_kind"],
                       by_kernel=st["by_kernel"],
                       argument_bytes=mem["argument_bytes"],
                       temp_bytes=mem["temp_bytes"],
                       fits_hbm=mem["fits_hbm"],
                       notes=rec.get("notes"))
        else:
            row["error"] = rec.get("error")
        rows.append(row)
        print(json.dumps({"pod_child": row}), flush=True)
    with open(f"{tmp}/pod.json", "w") as f:
        json.dump(rows, f)
    return 0 if all(r["status"] == "ok" for r in rows) else 1


def start_pod_child():
    """Start :func:`pod_child` (host work only) in a temporary directory;
    returns ``(process, directory)``."""
    import atexit
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pod_")
    with open(f"{tmp}/child.log", "w") as log:
        proc = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                                 POD_CHILD_FLAG, tmp], stdout=log,
                                stderr=subprocess.STDOUT)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc, tmp


def _step_tensors(result) -> dict:
    """A decode step's logits and caches, or a prefill's logits, by name;
    a ``DTensor`` as its local shard."""
    logits, caches = result if isinstance(result, tuple) else (result, {})
    out = {"logits": logits, **caches}
    return {k: v.to_local() if hasattr(v, "to_local") else v
            for k, v in out.items()}


def phase_pod_count(device, child) -> dict:
    """The sharded step under the op counter.  (i) On the card: each
    ``POD_COUNT["cells"]`` cell of phi4-mini at full width and depth
    (seed 0) run as a sharded step on a one-rank NCCL ``DeviceMesh`` (1,
    1), every argument a ``DTensor`` by the rule tables and the kernels on
    the local shards (``launch/dryrun.count_sharded``): its logits and
    caches bit for bit the unsharded step's, each kernel's launches equal
    to the counter's calls of it, the card's count equal field for field
    to the fake group's at (1, 1) and to the one-card dry run's, and no
    collective byte.  (ii) The child's pod counts (16 x 16 and 2 x 16 x
    16), printed a cell a line, their collectives equal to
    ``POD_COUNT["collectives"]``."""
    import shutil
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import (device_mesh, fake_process_mesh,
                                         release_process_group)
    from repro_torch.models.model import Model
    proc, tmp = child
    arch = POD_COUNT["arch"]
    t0 = time.perf_counter()
    check(not torch.distributed.is_initialized(),
          "pod_count: a process group is up before the fake-group count")
    fake = {}
    for shape, kw in POD_COUNT["cells"]:
        rec = dryrun.run_cell(arch, shape, out_dir=None, **_pod_options(kw))
        check(rec["status"] == "ok", f"pod_count one-card {shape}: "
                                     f"{rec.get('error')}")
        with fake_process_mesh((1, 1), ("data", "model")) as mesh, \
                FakeTensorMode():
            _, st, _, _, _ = dryrun.count_sharded(
                arch, shape, mesh, device="cpu", **_pod_options(kw))
        fake[shape] = st.as_dict()
        check(fake[shape] == rec["stats"],
              f"pod_count {shape}: the fake group's (1, 1) count differs "
              f"from the one-card record")
    fake_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    params = Model(get_config(arch), device=device).init(
        torch.Generator(device).manual_seed(0), quantize=True)
    torch.cuda.synchronize(device)
    draw_s = time.perf_counter() - t1
    cells = []
    mesh = device_mesh("cuda", [[0]], ("data", "model"))
    try:
        check(torch.distributed.get_backend() == "nccl",
              "pod_count: the one-rank mesh is NCCL")
        for shape, kw in POD_COUNT["cells"]:
            t1 = time.perf_counter()
            step, args, _ = dryrun.build_cell(arch, shape, device=device,
                                              params=params,
                                              **_pod_options(kw))
            want = {k: v.clone() for k, v in
                    _step_tensors(step(*args)).items()}
            del step, args
            _reset_matmul_counts()
            _reset_attention_counts()
            before = dryrun._launches()
            result, st, _, _, _ = dryrun.count_sharded(
                arch, shape, mesh, device=device, params=params,
                **_pod_options(kw))
            torch.cuda.synchronize(device)
            launched = {k: v - before[k]
                        for k, v in dryrun._launches().items()}
            got = _step_tensors(result)
            card = st.as_dict()
            row = {"shape": shape, **kw,
                   "bit_for_bit": {k: bool(torch.equal(got[k], want[k]))
                                   for k in want},
                   "on_card": all(t.is_cuda for t in got.values()),
                   "card_equals_fake_1x1": card == fake[shape],
                   "collective_bytes": card["collective_bytes"],
                   "by_kernel": card["by_kernel"], "launched": launched,
                   "launches": {**_matmul_counts(), **_attention_counts()},
                   "seconds": time.perf_counter() - t1}
            cells.append(row)
            del result, got, want
            print(f"pod_count {arch} {shape} {kw} on a one-rank NCCL mesh: "
                  f"bit for bit {row['bit_for_bit']}, launches {launched}, "
                  f"count == fake (1, 1) {row['card_equals_fake_1x1']}",
                  flush=True)
            check(row["on_card"], f"pod_count {shape}: a result off the "
                                  f"card")
            for k, same in row["bit_for_bit"].items():
                check(same, f"pod_count {shape}: {k} differs from the "
                            f"unsharded step")
            check(row["card_equals_fake_1x1"],
                  f"pod_count {shape}: the card's count {card} differs "
                  f"from the fake group's {fake[shape]}")
            check(card["collective_bytes"] == 0,
                  f"pod_count {shape}: collective bytes on one rank")
            for name, k in card["by_kernel"].items():
                check(launched[name] == k["calls"] > 0,
                      f"pod_count {shape}: {k['calls']} {name} calls "
                      f"counted, {launched[name]} launched")
    finally:
        release_process_group()
    del params
    torch.cuda.empty_cache()
    seen = {name for row in cells for name in row["by_kernel"]}
    check(seen == {"w8a8_matmul", "w8a8_decode_attention",
                   "flash_attention"},
          f"pod_count: kernels on the local shards {sorted(seen)}")
    t1 = time.perf_counter()
    try:
        proc.wait(timeout=POD_COUNT["timeout_s"])
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    wait_s = time.perf_counter() - t1
    try:
        with open(f"{tmp}/child.log") as f:
            log = f.read()
        check(proc.returncode == 0,
              f"pod_count child exit {proc.returncode}: {log[-3000:]}")
        with open(f"{tmp}/pod.json") as f:
            pods = json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for row in pods:
        check(row["status"] == "ok",
              f"pod_count {row['shape']} on {row['mesh']}: {row.get('error')}")
        coll = {k: round(v) for k, v in
                row["collective_bytes_by_kind"].items()}
        pinned = POD_COUNT["collectives"][(row["shape"], row["mesh"])]
        row["collectives_as_pinned"] = \
            (coll, row["collective_count_by_kind"]) == pinned
        check(row["collectives_as_pinned"],
              f"pod_count {row['shape']} on {row['mesh']}: collectives "
              f"{coll} {row['collective_count_by_kind']} under torch "
              f"{row['torch']}, pinned {pinned}")
        print(f"pod_count {arch} {row['shape']} on {row['mesh']}"
              f"{' kv_seq_shard' if row['kv_seq_shard'] else ''} "
              f"({row['chips']} cards): bottleneck {row['bottleneck']}, "
              f"step {row['step_time_s']:.6g} s (compute "
              f"{row['compute_s']:.4g}, memory {row['memory_s']:.4g}, "
              f"collective {row['collective_s']:.4g}), FLOPs a card "
              f"{row['flops_by_class']}, collective bytes a card {coll}, "
              f"fits_hbm {row['fits_hbm']}", flush=True)
    return {"phase": "pod_count", "arch": arch, "cells": cells,
            "pods": pods, "fake_count_s": fake_s, "w8a8_draw_s": draw_s,
            "child_wait_s": wait_s,
            "launches": {k: sum(row["launches"][k] for row in cells)
                         for k in cells[0]["launches"]},
            "seconds": time.perf_counter() - t0}


def main() -> int:
    import torch
    if len(sys.argv) == 3 and sys.argv[1] == POD_CHILD_FLAG:
        return pod_child(sys.argv[2])
    if len(sys.argv) == 4 and sys.argv[1] == CHILD_FLAG:
        return resume_child(sys.argv[2], sys.argv[3])
    if len(sys.argv) == 4 and sys.argv[1] == MESH_CHILD_FLAG:
        return mesh_child(int(sys.argv[2]), sys.argv[3])
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script measures the "
              "port on an NVIDIA GPU", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    t_start = time.perf_counter()
    smi = nvidia_smi()
    pod_child_proc = start_pod_child()
    emit(phase_build())
    print(smi, flush=True)
    main_path = phase_main_path(device)
    emit(main_path)
    emit(phase_headline_exact(main_path))
    parity = phase_parity(device)
    emit(parity)
    emit(phase_explore_many(device))
    coexplore = phase_coexplore(device)
    emit(coexplore)
    coexplore_many = phase_coexplore_many(device)
    emit(coexplore_many)
    emit(phase_coexplore_golden(device))
    fleet_parity = phase_fleet_parity(device)
    emit(fleet_parity)
    fleet_timing = phase_fleet_timing(device)
    emit(fleet_timing)
    coexplore_serving = phase_coexplore_serving(device)
    emit(coexplore_serving)
    emit(phase_serving_front_shift(device))
    emit(phase_scalar_oracle())
    emit(phase_ppa(device))
    emit(phase_rtl())
    emit(phase_resume(device))
    emit(phase_telemetry(device))
    timing = phase_timing(device)
    emit(timing)
    serve = {q: phase_serve(device, q) for q in ("w8a8", "w4a8_pow2")}
    for q in serve:
        emit(serve[q])
    for q in ("w8a8", "w4a8_pow2"):
        emit(phase_serve_parity(device, q))
    qparity = phase_qmatmul_parity(device)
    emit(qparity)
    qtiming = phase_qmatmul_timing(device)
    emit({"phase": "qmatmul_timing_context",
          "bf16_matmul_on_predecoded_w4a8_weights_ms":
          qtiming.pop("bf16_matmul_context_ms")})
    emit(qtiming)
    qprefill = phase_qmatmul_prefill_timing(device)
    emit(qprefill)
    emit(phase_qmatmul_regimes(device))
    model, params, _ = _full_model("w8a8", device)
    batcher = phase_batcher(device, model, params)
    emit(batcher)
    emit(phase_batcher_parity(device, params))
    prefill = phase_prefill(device, params)
    emit(prefill)
    del model, params
    fp32 = phase_prefill_fp32(device)
    emit(fp32)
    ssm_serve = {family: phase_arch_serve(device, arch, f"{family}_serve")
                 for family, arch in SSM_ARCHS.items()}
    for family in SSM_ARCHS:
        ssm_serve[family].pop("stream")
        emit(ssm_serve[family])
    ssm_prefill = phase_ssm_prefill(device)
    emit(ssm_prefill)
    ssm_tc = phase_ssm_tc_shapes(device)
    emit(ssm_tc)
    emit(phase_loss(device))
    window_serve = phase_arch_serve(device, WINDOW_ARCH, "window_serve")
    window_serve.pop("stream")
    emit(window_serve)
    model, params = _arch_model(WINDOW_ARCH, device)
    window_batcher = phase_batcher(device, model, params,
                                   name="window_batcher")
    emit(window_batcher)
    window_ring = phase_window_ring(device, model, params)
    emit(window_ring)
    window_prefill = phase_window_prefill(device, model, params)
    emit(window_prefill)
    del model, params
    window_wrap = phase_window_wrap(device)
    emit(window_wrap)
    torch.cuda.empty_cache()
    model, params = _arch_model(MOE_ARCH, device, impl="kernel")
    moe_serve = phase_arch_serve(device, MOE_ARCH, "moe_serve",
                                 built=(model, params))
    stream = moe_serve.pop("stream")
    emit(moe_serve)
    moe_int8kv = phase_moe_int8kv(device, "moe_int8kv", model, params,
                                  stream)
    emit(moe_int8kv)
    moe_prefill = phase_moe_prefill(device, model, params)
    emit(moe_prefill)
    del model, params, stream
    torch.cuda.empty_cache()
    moe_phi35 = phase_moe_phi35(device)
    emit(moe_phi35)
    cross = {}
    for family, spec in CROSS_ARCHS.items():
        torch.cuda.empty_cache()
        model, params = _arch_model(spec["arch"], device, impl="kernel",
                                    n_layers=spec["n_layers"])
        for phase in (phase_cross_serve, phase_cross_prefill):
            row = phase(device, family, model, params)
            cross[row["phase"]] = row
            emit(row)
        del model, params
    torch.cuda.empty_cache()
    aparity = phase_attention_parity(device)
    emit(aparity)
    atiming = phase_attention_timing(device)
    emit(atiming)
    torch.cuda.empty_cache()
    import tempfile
    with tempfile.TemporaryDirectory() as cache:
        emit(phase_calibrate(device, cache))
        validate = phase_validate_elites(device, cache)
        emit(validate)
    emit(phase_grad_guard(device))
    train_row = phase_train(device)
    emit(train_row)
    restart_row = phase_train_restart(device)
    emit(restart_row)
    roofline = phase_roofline(device)
    emit(roofline)
    mesh = phase_mesh(device)
    emit(mesh)
    pod = phase_pod_count(device, pod_child_proc)
    emit(pod)
    emit({"phase_seconds": PHASE_SECONDS})
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    qat = {f"train ({TRAIN['arch']}, W8A8 QAT, {TRAIN['steps']} steps)":
           train_row["launches"]["w8a8_matmul"]
           + train_row["launches"]["w4a8_matmul"],
           f"train_restart ({TRAIN_RESTART['arch']}, W8A8 QAT, int8 "
           "gradient compression, 2 restarts)":
           restart_row["launches"]["w8a8_matmul"]
           + restart_row["launches"]["w4a8_matmul"]}
    roof = f"roofline ({ROOFLINE['arch']}, 4 measured cells)"
    podk = f"pod_count ({POD_COUNT['arch']}, one-rank NCCL mesh)"
    per = (f"one {SERVE_ARCH} layer's 7 projections at m = "
           f"{SERVE['batch']}, weights cold in L2")
    sweep = timing["vgg16"]
    kernels = [{
        "name": "sweep_aggregates",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sweep_kernel.cu",
        "replaces": "src/repro/kernels/sweep_kernel.py:156",
        "launches": main_path["launches"],
        "max_abs_err": parity["worst"]["max_abs_vs_plain"],
        "max_rel_err": parity["worst"]["rel_vs_plain"],
        "ms": sweep["profiled_kernel_ms"],
        "plain_ms": min(sweep["plain_ms"]),
        "bound_ms": sweep["bound_ms"],
        "bound_by": sweep["bound_by"],
        "library_ms": None,
        "event_ms": min(sweep["kernel_ms"]),
        "issue_bound_ms": sweep["issue_bound_ms"],
        "grid": sweep["grid"],
        "launches_by_path": {
            "main_path": main_path["launches"],
            "mesh, one-rank NCCL mesh (the mesh runs of the phase)":
                mesh["one_rank_launches"],
            "mesh, 4 gloo ranks on the card (each rank)":
                mesh["four_ranks"]["sweep_launches_by_rank"]},
        "launches_coexplore": {"coexplore": coexplore["launches"],
                               "coexplore_many": coexplore_many["launches"],
                               "coexplore_serving":
                               coexplore_serving["launches"]},
        "other_shapes": {
            shape: {key: timing[shape][key] for key in (
                "n", "l", "w", "grid", "profiled_kernel_ms", "bound_ms",
                "issue_bound_ms")}
            for shape in TIMING_SHAPES if shape != "vgg16"},
        "per": f"one launch at N = {sweep['n']}, L = {sweep['l']}, W = "
               f"{sweep['w']} (profiler device time, the smallest of three "
               "windows; event_ms: CUDA events over back-to-back launches; "
               "grid: blocks, threads and shared-memory bytes as the C "
               "entry reported them; issue_bound_ms: the cells' SASS "
               "instructions over the card's schedulers at its maximum SM "
               "clock)",
    }]
    w8 = "src/repro_torch/kernels/csrc/w8a8_matmul.cu"
    lay = qtiming["w8a8"]["layer"]
    kernels.append({
        "name": "w8a8_matmul_dp4a",
        "route": "cuda",
        "source": w8,
        "replaces": "src/repro/kernels/w8a8_matmul.py:69",
        "launches": serve["w8a8"]["launches"]["w8a8_matmul_dp4a"],
        "max_abs_err": qparity["worst"]["w8a8_dp4a"][0],
        "max_rel_err": qparity["worst"]["w8a8_dp4a"][1],
        "ms": lay["kernel_ms"],
        "plain_ms": lay["plain_ms"],
        "bound_ms": lay["bound_ms"],
        "bound_by": lay["bound_by"],
        "library_ms": lay["library_ms"],
        "per": per + " (split-k dp4a regime, m < TC_MIN_M)",
        "launches_by_path": {
            f"serve_w8a8 ({SERVE_ARCH})":
                serve["w8a8"]["launches"]["w8a8_matmul_dp4a"],
            **{f"{f}_serve ({SSM_ARCHS[f]})":
               ssm_serve[f]["launches"]["w8a8_matmul_dp4a"]
               for f in SSM_ARCHS},
            f"window_serve ({WINDOW_ARCH})":
                window_serve["launches"]["w8a8_matmul_dp4a"],
            f"moe_serve ({MOE_ARCH})":
                moe_serve["launches"]["w8a8_matmul_dp4a"],
            f"moe_int8kv ({MOE_ARCH})":
                moe_int8kv["launches"]["w8a8_matmul_dp4a"],
            f"moe_phi35_serve ({MOE_PHI['arch']}, "
            f"{MOE_PHI['n_layers']} layers)":
                moe_phi35["serve"]["launches"]["w8a8_matmul_dp4a"],
            **{f"{f}_serve ({cross[f + '_serve']['arch']}, "
               f"{cross[f + '_serve']['n_layers']} layers)":
               cross[f + "_serve"]["launches"]["w8a8_matmul_dp4a"]
               for f in CROSS_ARCHS}, **qat,
            roof: roofline["launches"]["w8a8_matmul_dp4a"],
            podk: pod["launches"]["w8a8_matmul_dp4a"]},
        "moonshot_layer": moe_prefill["w8a8_decode_layer"]["layer"],
    })
    lay = qprefill["layer"]
    kernels.append({
        "name": "w8a8_matmul_tc",
        "route": "cuda",
        "source": w8,
        "replaces": "src/repro/kernels/w8a8_matmul.py:69",
        "launches": prefill["forward_launches"]["w8a8_matmul_tc"],
        "max_abs_err": qparity["worst"]["w8a8_tc"][0],
        "max_rel_err": qparity["worst"]["w8a8_tc"][1],
        "ms": lay["kernel_ms"],
        "plain_ms": lay["plain_ms"],
        "bound_ms": lay["bound_ms"],
        "bound_by": lay["bound_by"],
        "library_ms": lay["library_ms"],
        "per": f"one {SERVE_ARCH} layer's 7 projections at m = "
               f"{PREFILL_M} (int8 wgmma regime, {qprefill['timer']} "
               f"time); launches per 1 x {PREFILL_M} forward",
        "launches_by_path": {
            f"prefill ({SERVE_ARCH})":
                prefill["forward_launches"]["w8a8_matmul_tc"],
            **{f"ssm_prefill ({SSM_ARCHS[f]})":
               ssm_prefill[f]["launches"]["w8a8_matmul_tc"]
               for f in SSM_ARCHS},
            f"window_prefill ({WINDOW_ARCH})":
                window_prefill["launches"]["w8a8_matmul_tc"],
            f"moe_prefill ({MOE_ARCH})":
                moe_prefill["launches"]["w8a8_matmul_tc"],
            **{f"{f}_prefill ({cross[f + '_prefill']['arch']}, "
               f"{cross[f + '_prefill']['n_layers']} layers)":
               cross[f + "_prefill"]["launches"]["w8a8_matmul_tc"]
               for f in CROSS_ARCHS},
            **{f"{f}_serve fill_ctx_caches ({cross[f + '_serve']['arch']})":
               cross[f + "_serve"]["fill_launches"]["w8a8_matmul_tc"]
               for f in CROSS_ARCHS}, **qat,
            roof: roofline["launches"]["w8a8_matmul_tc"],
            podk: pod["launches"]["w8a8_matmul_tc"]},
        "context_kv_shapes": {
            f"{cross[f + '_serve']['arch']}": cross[f + "_serve"][
                "w8a8_context_kv"]["layer"] for f in CROSS_ARCHS},
        "ssm_shapes": {key: {k: ssm_tc[key][k] for k in (
            "aligned", "kernel_ms", "kernel_again_ms", "plain_ms",
            "library_ms", "bound_ms")}
            for key in (f"{k}x{n}" for k, n in SSM_TC_SHAPES)},
    })
    lay = qtiming["w4a8"]["layer"]
    kernels.append({
        "name": "w4a8_matmul",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/w4a8_matmul.cu",
        "replaces": "src/repro/kernels/w4a8_matmul.py:96",
        "launches": serve["w4a8_pow2"]["launches"]["w4a8_matmul"],
        "max_abs_err": qparity["worst"]["w4a8"][0],
        "max_rel_err": qparity["worst"]["w4a8"][1],
        "ms": lay["kernel_ms"],
        "plain_ms": lay["plain_ms"],
        "bound_ms": lay["bound_ms"],
        "bound_by": lay["bound_by"],
        "library_ms": lay["library_ms"],
        "grid": {f"{k}x{n}": {key: qtiming["w4a8"][f"{k}x{n}"][key]
                              for key in ("splits", "blocks")}
                 for k, n in LAYER_PROJ},
        "launches_by_path": {
            f"serve_w4a8_pow2 ({SERVE_ARCH})":
                serve["w4a8_pow2"]["launches"]["w4a8_matmul"], **qat,
            roof: roofline["launches"]["w4a8_matmul"]},
        "per": per + " (split-k; splits and blocks as the C entry "
                     "reported its launch; launches: W4A8 serve run)",
    })
    dec = atiming["decode"][str(DECODE_S[0])]
    moe_dec_rows = list(moe_int8kv["decode_timing"].values()) \
        + list(moe_phi35["int8kv"]["decode_timing"].values())
    dec_rows = list(atiming["decode"].values()) \
        + list(window_ring["decode_timing"].values()) + moe_dec_rows
    b, kvh, rep, hd = DECODE_SHAPE
    kernels.append({
        "name": "w8a8_decode_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/w8a8_decode.cu",
        "replaces": "src/repro/kernels/w8a8_decode.py:100",
        "launches": batcher["launches"]["w8a8_decode_attention"],
        "max_abs_err": max([aparity["worst"]["decode"][0]]
                           + [r["max_abs_err"] for r in dec_rows]),
        "max_rel_err": max([aparity["worst"]["decode"][1]]
                           + [r["rel_to_max"] for r in dec_rows]),
        "ms": dec["best_kernel_ms"],
        "plain_ms": dec["best_plain_ms"],
        "bound_ms": dec["bound_ms"],
        "bound_by": dec["bound_by"],
        "library_ms": None,
        "event_ms": min(dec["kernel_event_ms"], dec["kernel_again_event_ms"]),
        "splits": dec["splits"],
        "kernel_launches": batcher["launches"]["w8a8_decode_attention_kernels"],
        "launches_per_call": dec["launches_per_call"],
        "per": f"one layer's decode attention at b {b}, kvh {kvh}, rep "
               f"{rep}, hd {hd}, S {DECODE_S[0]}, bs = S, every key live, "
               f"inputs cold in L2 ({dec['timer']} time; event_ms: CUDA "
               f"events over back-to-back calls), grid {dec['grid']}, "
               f"{dec['launches_per_call']:g} launches a call; launches: "
               "calls in the batcher run, kernel_launches: the kernels "
               "they launched",
        "launches_by_path": {
            f"serve_batcher_int8kv ({SERVE_ARCH})":
                batcher["launches"]["w8a8_decode_attention"],
            f"window_batcher ({WINDOW_ARCH})":
                window_batcher["launches"]["w8a8_decode_attention"],
            f"window_ring ({WINDOW_ARCH}, one local layer)":
                window_ring["launches"]["w8a8_decode_attention"],
            f"window_wrap ({WINDOW_ARCH}, 6 layers)":
                window_wrap["launches"]["w8a8_decode_attention"],
            f"moe_int8kv ({MOE_ARCH}, rep 1)":
                moe_int8kv["launches"]["w8a8_decode_attention"],
            f"moe_phi35_int8kv ({MOE_PHI['arch']}, "
            f"{MOE_PHI['n_layers']} layers, rep 4)":
                moe_phi35["int8kv"]["launches"]["w8a8_decode_attention"],
            roof: roofline["launches"]["w8a8_decode_attention"],
            podk: pod["launches"]["w8a8_decode_attention"]},
        "moe_shapes": {f"rep {r['shape'][2]}": {
            k: r[k] for k in (
                "shape", "splits", "positions", "max_abs_err", "rel_to_max",
                "best_kernel_ms", "best_plain_ms", "timer", "bound_ms",
                "bound_by")}
            for r in moe_dec_rows},
        "wrapped_ring_max_abs_vs_plain":
            window_ring["worst"]["kernel_vs_plain"],
        "gemma3_shapes": {S: {k: r[k] for k in (
            "shape", "splits", "positions", "max_abs_err", "rel_to_max",
            "best_kernel_ms", "best_plain_ms", "timer", "bound_ms",
            "bound_by")}
            for S, r in window_ring["decode_timing"].items()},
    })
    fl = atiming["flash"]
    kernels.append({
        "name": "flash_attention_tc",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_tc.cu",
        "replaces": "src/repro/kernels/flash_attention.py:109",
        "launches": prefill["flash_launches_per_forward"],
        "max_abs_err": aparity["worst"]["flash_bfloat16"][0],
        "max_rel_err": aparity["worst"]["flash_bfloat16"][1],
        "ms": fl["best_kernel_ms"],
        "plain_ms": fl["best_plain_ms"],
        "bound_ms": fl["bound_ms"],
        "bound_by": fl["bound_by"],
        "library_ms": fl["best_library_ms"],
        "per": "one layer's causal attention at (b 1, h 24, s 4096, d 128) "
               f"bf16 ({fl['timer']} time), the bf16 tensor-core route; "
               "launches per 1 x 4096 W8A8 forward",
        "launches_by_path": {
            f"prefill ({SERVE_ARCH})": prefill["flash_launches_per_forward"],
            f"ssm_prefill ({SSM_ARCHS['hybrid']})":
                ssm_prefill["hybrid"]["launches"]["flash_attention_tc"],
            f"window_prefill ({WINDOW_ARCH})":
                window_prefill["launches"]["flash_attention_tc"],
            f"window_prefill ({WINDOW_ARCH}), window 1024":
                window_prefill["launches"]["flash_attention_windowed"],
            f"moe_prefill ({MOE_ARCH})":
                moe_prefill["launches"]["flash_attention_tc"],
            **{f"{ph} ({cross[ph]['arch']}, {cross[ph]['n_layers']} "
               f"layers)": cross[ph]["launches"]["flash_attention_tc"]
               for ph in cross},
            **{f"validate_elites ({a}, {validate[a]['layers']} layers at "
               f"reduced width, {validate[a]['distinct_plans']} plans + "
               "the baseline)": validate[a]["launches"]["flash_attention_tc"]
               for a in (VALIDATE["attention_model"],)},
            f"train ({TRAIN['attention_arch']}, {TRAIN['attention_layers']}"
            " layers, under grad)":
                train_row["attention_step"]["launches"][
                    "flash_attention_tc"],
            f"train_restart ({TRAIN_RESTART['arch']}, under grad)":
                restart_row["launches"]["flash_attention"],
            roof: roofline["launches"]["flash_attention_tc"],
            podk: pod["launches"]["flash_attention_tc"]},
        "cross_family_shapes": {
            f"{ph} {kind}": {k: r[k] for k in (
                "shape", "keys", "causal", "dtype", "best_kernel_ms",
                "best_plain_ms", "best_library_ms", "timer", "bound_ms",
                "bound_by", "kernel_max_abs_vs_plain")}
            for ph in cross for kind, r in (
                cross[ph]["flash_timing"].items()
                if ph.endswith("_prefill")
                else [("cross", cross[ph]["flash_timing"])])},
        "moe_shapes": {f"h {r['shape'][1]}": {k: r[k] for k in (
            "shape", "best_kernel_ms", "best_plain_ms", "best_library_ms",
            "timer", "bound_ms", "bound_by", "kernel_max_abs_vs_plain")}
            for r in (moe_prefill["flash_timing"],
                      moe_phi35["flash_timing"])},
        "gemma3_layers": {key: {k: r[k] for k in (
            "shape", "window", "best_kernel_ms", "best_plain_ms",
            "best_library_ms", "timer", "bound_ms", "bound_by",
            "kernel_max_abs_vs_plain")}
            for key, r in window_prefill["flash_timing"].items()},
    })
    fl = atiming["flash_f32"]
    kernels.append({
        "name": "flash_attention_f32",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:109",
        "launches": fp32["launches"]["flash_attention_f32"],
        "max_abs_err": aparity["worst"]["flash_float32"][0],
        "max_rel_err": aparity["worst"]["flash_float32"][1],
        "ms": fl["best_kernel_ms"],
        "plain_ms": fl["best_plain_ms"],
        "bound_ms": fl["bound_ms"],
        "bound_by": fl["bound_by"],
        "library_ms": fl["best_library_ms"],
        "bound_cuda_core_ms": fl["ops_cuda_core_ms"],
        "library_kernel": fl["library_kernel"],
        "library_max_abs_vs_plain": fl["library_max_abs_vs_plain"],
        "launches_by_path": {
            f"prefill_fp32 ({SERVE_ARCH}, {FP32_LAYERS} layers)":
                fp32["launches"]["flash_attention_f32"],
            f"vlm_prefill ({cross['vlm_prefill']['arch']}, "
            f"{cross['vlm_prefill']['n_layers']} layers), cross layers on "
            "a float32 context":
                cross["vlm_prefill"]["launches"]["flash_attention_f32"]},
        "per": "one layer's causal attention at (b 1, h 24, s 4096, d 128) "
               f"float32 ({fl['timer']} time), 3xTF32 on the tensor cores, "
               "bound at 3 x its FLOP at the 494.7 TFLOP/s TF32 rate "
               "(bound_cuda_core_ms: at the 67 TFLOP/s float32 rate); "
               f"launches per 1 x 4096 FP32 forward of {FP32_LAYERS} "
               "layers",
    })
    ft = fleet_timing[str(len(KEEP["fleet_chunk"][0]))]
    kernels.append({
        "name": "fleet_sim",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fleet_sim.cu",
        "replaces": "src/repro/serving/fleet_sim.py:214 (_jax_sim, a "
                    "jitted fori_loop; not a Pallas kernel)",
        "launches": coexplore_serving["fleet_launches"],
        "max_abs_err": fleet_parity["max_abs_vs_plain"],
        "ms": ft["kernel_ms"],
        "plain_ms": ft["plain_ms"],
        "bound_ms": ft["bound_ms"],
        "bound_by": ft["bound_by"],
        "library_ms": None,
        "event_ms": ft["event_ms"],
        "call_device_ms": ft["device_ms"],
        "d2h_ms": ft["d2h_ms"],
        "cpu_route_ms": ft["cpu_route_ms"],
        "grid": ft["grid"],
        "per": f"one launch at N = {ft['n']} candidates (the main path's "
               f"chunk), {fleet_timing['requests']} requests of the "
               f"{fleet_timing['trace']} trace, {fleet_timing['n_slots']} "
               "slots (profiler device time of the kernel, the largest of "
               "three windows; call_device_ms with the transposes; "
               "event_ms: CUDA events over back-to-back calls; d2h_ms: the "
               "stamps to the host); launches: the serving-default search, "
               "one an evaluation chunk",
    })
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
