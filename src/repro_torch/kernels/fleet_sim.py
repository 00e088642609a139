"""The serving-fleet simulator's stamps: every candidate's continuous
batcher replayed against one request trace.

Replaces no Pallas kernel.  It replaces the reference's jitted
``jax.lax.fori_loop`` ``repro/serving/fleet_sim.py::_jax_sim`` (called by
``_simulate_jax``), which steps every candidate through every iteration
and slot in one XLA program; in eager PyTorch that loop would be ~10^5
small launches.  The card path is one CUDA kernel written for Hopper,
``csrc/fleet_sim.cu``; its header says what bounds it and how it is laid
out.

What it computes: for ``N`` candidates of ``step_s`` seconds an
iteration and ``R`` requests (``arrival_s`` sorted ascending, ``svc``
service iterations each), the reference's ``(submit_iter, comp_iter,
active_iters)`` as int64 — one thread per candidate walking the requests
in FIFO order, the reference's ``simulate_fleet_scalar``.  The arrival
iteration ``ceil(arrival_s / step_s)`` is computed inside in float64
(IEEE division, as numpy's), so every stamp is exact.

The plain version, :func:`fleet_stamps_ref`, is the same walk in torch,
vectorized over candidates with a Python loop over the requests; the
CPU route and the tests use it, and ``chip_smoke.py`` compares the kernel
with it on the card.  The wrapper :func:`fleet_stamps` takes it only for
tensors on the CPU; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels._workspace import current_stream

#: the most slots a thread keeps in registers (the kernel's kMaxRegSlots);
#: above it the slots' free times live in a workspace of n_slots x N int64
MAX_REGISTER_SLOTS = 16
#: threads a block (the kernel's kThreads)
THREADS = 256

#: kernel launches since the counter was last set to 0
launches = 0
#: the last launch as the C entry reported it: (blocks, threads a block,
#: register slots, 0 for the workspace path)
last_grid = None
_Info = ctypes.c_int * 3


class Stamps(NamedTuple):
    """Iteration stamps of N candidates over R requests: ``submit`` (N, R)
    (-1 = never admitted), ``comp`` (N, R) (0 = never admitted), ``active``
    (N,) iterations with a busy slot; int64 on the inputs' device."""
    submit: torch.Tensor
    comp: torch.Tensor
    active: torch.Tensor


def _check(step_s, arrival_s, svc, n_slots: int, n_iters: int) -> None:
    if step_s.dim() != 1 or arrival_s.dim() != 1 or svc.dim() != 1:
        raise ValueError("fleet_stamps: step_s, arrival_s and svc are 1-D")
    if arrival_s.shape != svc.shape:
        raise ValueError(
            f"fleet_stamps: {arrival_s.shape[0]} arrivals but "
            f"{svc.shape[0]} service lengths")
    if step_s.dtype != torch.float64 or arrival_s.dtype != torch.float64 \
            or svc.dtype != torch.int64:
        raise ValueError(
            "fleet_stamps: step_s and arrival_s are float64, svc int64")
    if not (step_s.device == arrival_s.device == svc.device):
        raise ValueError(
            f"fleet_stamps: inputs on {step_s.device}, {arrival_s.device} "
            f"and {svc.device}; they share one device")
    if not all(t.is_contiguous() for t in (step_s, arrival_s, svc)):
        raise ValueError("fleet_stamps: inputs must be contiguous")
    if step_s.numel() < 1 or svc.numel() < 1:
        raise ValueError(
            "fleet_stamps: need at least one candidate and one request")
    if n_slots < 1:
        raise ValueError(f"fleet_stamps: n_slots must be >= 1, got {n_slots}")
    if not 1 <= n_iters < 2 ** 31 - 1:
        raise ValueError(
            f"fleet_stamps: the horizon {n_iters} is not in [1, 2^31 - 1)")


def fleet_stamps_ref(step_s: torch.Tensor, arrival_s: torch.Tensor,
                     svc: torch.Tensor, n_slots: int,
                     n_iters: int) -> Stamps:
    """The plain version on any device: the FIFO walk vectorized over
    candidates, one step of ~15 ops over ``(N, n_slots)`` a request."""
    n, r = step_s.shape[0], svc.shape[0]
    dev = step_s.device
    arrive = torch.ceil(arrival_s[None, :] / step_s[:, None]).to(torch.int64)
    free_at = torch.zeros((n, n_slots), dtype=torch.int64, device=dev)
    slot_ids = torch.arange(n_slots, device=dev).expand(n, n_slots)
    submit = torch.full((n, r), -1, dtype=torch.int64, device=dev)
    comp = torch.zeros((n, r), dtype=torch.int64, device=dev)
    admitting = torch.ones(n, dtype=torch.bool, device=dev)
    cur_s = torch.full((n,), -1, dtype=torch.int64, device=dev)
    cur_e = cur_s.clone()
    active = torch.zeros(n, dtype=torch.int64, device=dev)
    for j in range(r):
        mn = free_at.min(dim=1).values
        # the slot that frees first, lowest index on ties
        slot = torch.where(free_at == mn[:, None], slot_ids,
                           n_slots).min(dim=1).values
        start = torch.maximum(arrive[:, j], mn)
        admitting &= start < n_iters
        end_at = start + svc[j]
        submit[:, j] = torch.where(admitting, start, -1)
        comp[:, j] = torch.where(admitting, end_at, 0)
        free_at.scatter_(1, slot[:, None],
                         torch.where(admitting, end_at, mn)[:, None])
        # the union of busy spans [start, min(comp, n_iters)), summed as
        # the starts rise
        end = end_at.clamp(max=n_iters)
        fresh = admitting & (start > cur_e)
        active += torch.where(fresh & (cur_e > cur_s), cur_e - cur_s, 0)
        cur_s = torch.where(fresh, start, cur_s)
        cur_e = torch.where(admitting, torch.where(
            fresh, end, torch.maximum(cur_e, end)), cur_e)
    active += torch.where(cur_e > cur_s, cur_e - cur_s, 0)
    return Stamps(submit, comp, active)


def _launch(step_s, arrival_s, svc, n_slots: int, n_iters: int) -> Stamps:
    global launches, last_grid
    from repro_torch.kernels import _build
    lib = _build.library("fleet_sim")
    dev = step_s.device
    n, r = step_s.shape[0], svc.shape[0]
    submit = torch.empty((r, n), dtype=torch.int64, device=dev)
    comp = torch.empty((r, n), dtype=torch.int64, device=dev)
    active = torch.empty(n, dtype=torch.int64, device=dev)
    free_ws = (torch.empty((n_slots, n), dtype=torch.int64, device=dev)
               if n_slots > MAX_REGISTER_SLOTS else None)
    info = _Info()
    with torch.cuda.device(dev):
        err = lib.qappa_fleet_sim(
            step_s.data_ptr(), arrival_s.data_ptr(), svc.data_ptr(),
            submit.data_ptr(), comp.data_ptr(), active.data_ptr(),
            None if free_ws is None else free_ws.data_ptr(), n, r,
            n_slots, n_iters, info, current_stream(dev))
    if err != 0:
        raise RuntimeError(
            f"fleet_sim kernel launch failed: CUDA error {err} "
            f"({lib.qappa_error_string(err).decode()})")
    last_grid = tuple(info)
    launches += 1
    return Stamps(submit.t().contiguous(), comp.t().contiguous(), active)


def fleet_stamps(step_s: torch.Tensor, arrival_s: torch.Tensor,
                 svc: torch.Tensor, n_slots: int, n_iters: int) -> Stamps:
    """Iteration stamps of ``N`` candidates (``step_s`` (N,) float64
    seconds an iteration) over one trace (``arrival_s`` (R,) float64
    sorted ascending, ``svc`` (R,) int64 >= 1) on ``n_slots`` slots up to
    the horizon ``n_iters``.  CPU tensors -> the plain version; CUDA
    tensors -> the kernel, or an error.  The result is (N, R) either
    way; the kernel writes (R, N) columns (a warp's stores of one request
    contiguous) and they are transposed on the card."""
    _check(step_s, arrival_s, svc, n_slots, n_iters)
    dev = step_s.device
    if dev.type == "cpu":
        return fleet_stamps_ref(step_s, arrival_s, svc, n_slots, n_iters)
    if dev.type != "cuda":
        raise ValueError(
            f"fleet_stamps: tensors on {dev} are neither CPU nor CUDA")
    return _launch(step_s, arrival_s, svc, n_slots, n_iters)
