"""The training driver: the port of :mod:`repro.launch.train`.

Wires config -> :class:`~repro_torch.models.model.Model` -> a train step
(``Model.loss`` under QAT, its gradient by autograd, optional int8
gradient compression with error feedback, then
:func:`repro_torch.optim.adamw.update`) -> the synthetic data pipeline ->
checkpoint/restart (:func:`repro_torch.runtime.fault_tolerance.run_with_restarts`
when ``ckpt_dir`` is given).  The state is ``{"params", "opt", "err"}``,
``err`` the error-feedback tree under ``grad_compression`` and ``{}``
without.  The step runs under the reference's activation rules on a
mesh (:func:`~repro_torch.parallel.sharding.default_activation_rules`,
``seq_sharded=False``), and :func:`train` builds it on
:func:`~repro_torch.launch.mesh.make_host_mesh` over every rank of the
group, as the reference builds its mesh over every device.

What runs where:

* **One rank** (no group, or a one-rank group, which :func:`train`
  starts and releases again): the params stay plain tensors, on which
  the rules' ``shard`` is the identity, so the losses are those without
  a mesh bit for bit; the MoE layers route through ``moe_ffn_ep``.  A
  state the caller placed on a one-rank mesh (``DTensor`` leaves, every
  placement whole) runs placed, as the card's ``train_mesh`` phase of
  ``chip_smoke.py`` runs it on a one-rank NCCL mesh.
* **Several ranks** (a group the caller started: ``torchrun``, or
  ``torch.multiprocessing`` with gloo on the host; :func:`train` leaves
  it up): the state is placed by the rule tables, FSDP over "data", TP
  over "model", EP for the stacked experts (``_moe_ffn_ep_dtensor``),
  and each rank draws the same global batch from the ``SyntheticLM``
  seed and keeps its block of it.  Gradients, AdamW, int8 compression
  and checkpoints work on the placed leaves
  (:func:`make_train_step`).  The MoE's capacity and aux loss are per
  data shard, as in the reference's ``shard_map`` body, so an MoE
  model's sharded step is not its unsharded step.

Under grad every attention runs the plain route (the kernels have no
backward, ``kernels/ops.py``), and the projections of a quantized policy
are fake-quantized float products (``quant/qlinear.qdot``), so a
training step launches none of the port's kernels.

A checkpoint restores into a state on any device
(:func:`repro_torch.checkpoint.checkpoint.restore` with ``like`` there):
a run the card checkpointed continues on the CPU, and the other way
round.

Usage (the CPU at reduced width; on the card at full width drop
``--device cpu`` and add ``--full``; under ``torchrun`` the ranks' group
is started from its environment, gloo on the host)::

  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \\
      --device cpu --steps 20 --ckpt-dir /tmp/ckpt --grad-compression
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch mamba2-130m --device cpu --steps 6
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import time

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.core.device import resolve_device
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.kernels import ops
from repro_torch.models.model import Model
from repro_torch.models.tree import tree_flatten, tree_map
from repro_torch.optim import adamw
from repro_torch.launch.mesh import make_host_mesh, release_process_group
from repro_torch.parallel import compression
from repro_torch.parallel.sharding import (activation_sharding,
                                           default_activation_rules, place,
                                           place_batch, place_tree,
                                           placed_like, reduce_partial)
from repro_torch.runtime.fault_tolerance import run_with_restarts


def make_train_step(model: Model, mesh, ocfg: adamw.AdamWConfig, *,
                    grad_compression: bool = False):
    """``step(state, batch) -> (state, loss)`` with ``state = {"params",
    "opt", "err"}``: the QAT loss under ``mesh``'s activation rules (none
    for ``mesh=None``), its gradient with respect to every param leaf
    (zero for a leaf the loss does not reach, as ``jax.grad`` gives), with
    ``grad_compression`` its int8 round trip carrying the residual in
    ``err``, and one AdamW update.  The new state holds new tensors; the
    caller drops the old one.

    On a mesh of several ranks, or where a leaf of ``state`` already is a
    ``DTensor``, the step runs placed: every plain leaf of ``state`` (the
    same full tensor on every rank) becomes a ``DTensor`` by the rule
    tables (:func:`~repro_torch.parallel.sharding.tree_pspecs`: FSDP over
    "data", TP over "model", EP for the stacked experts), each rank
    keeping its own block, and the global ``batch`` is placed over the
    data axes with its sequence whole; each gradient is moved to its
    param's placements.  The state that comes back is placed, and
    ``loss`` is the replicated value as a plain 0-d tensor.  A plain state
    on a one-rank mesh runs as it does without one."""
    rules = None if mesh is None else default_activation_rules(
        mesh, seq_sharded=False)

    def train_step(state, batch):
        placed = mesh is not None and (mesh.size() > 1 or any(
            map(ops.sharded, tree_flatten(state)[0])))
        if not placed:
            return _step(state, batch)
        state = place_tree(mesh, state, lambda t, s: t if ops.sharded(t)
                           else place(t, mesh, s))
        # plain tensors the step makes (positions, masks, and their
        # gradients) are taken as replicated
        from torch.distributed.tensor.experimental import \
            implicit_replication
        with implicit_replication():
            state, loss = _step(state, place_batch(mesh, batch))
        return state, reduce_partial(loss).to_local()

    def _step(state, batch):
        params = tree_map(
            lambda p: p.detach().requires_grad_(True), state["params"])
        with (contextlib.nullcontext() if mesh is None
              else activation_sharding(mesh, rules)):
            loss = model.loss(params, batch)
        loss.backward()
        grads = tree_map(
            lambda p: placed_like(p.grad, p) if p.grad is not None
            else torch.zeros_like(p), params)
        err = state["err"]
        if grad_compression:
            grads, err = compression.compress_roundtrip(grads, err)
        new_params, opt, _ = adamw.update(ocfg, grads, state["opt"],
                                          params)
        return {"params": new_params, "opt": opt, "err": err}, loss.detach()

    return train_step


def context(cfg, batch: int, step: int, device) -> torch.Tensor:
    """The vlm / audio families' ``ctx`` of one step: a normal draw x
    0.02 from ``torch.Generator("cpu").manual_seed(step)`` (the reference
    draws it from ``jax.random.key(step)``)."""
    g = torch.Generator("cpu").manual_seed(step)
    return (torch.randn((batch, cfg.n_ctx_tokens, cfg.d_model),
                        generator=g) * 0.02).to(device)


def train(arch: str, *, steps: int = 20, smoke: bool = True,
          seq_len: int = 64, batch: int = 8, ckpt_dir: str | None = None,
          ckpt_every: int = 10, grad_compression: bool = False,
          fail_at: dict | None = None, log_every: int = 5, seed: int = 0,
          n_layers: int | None = None,
          device="cuda") -> list[tuple[int, float]]:
    """``steps`` AdamW steps of ``arch`` (reduced width with ``smoke``,
    else full; cut to ``n_layers`` layers where given) on ``SyntheticLM``
    batches; returns ``[(step, loss)]``.
    The params are drawn on the CPU from ``torch.Generator("cpu")
    .manual_seed(seed)`` and moved to ``device`` (the card unless the
    caller asks for the CPU), so both devices start from one draw.

    With ``ckpt_dir`` the loop is :func:`run_with_restarts`: a checkpoint
    every ``ckpt_every`` steps and at the last, ``fail_at`` ({step:
    times}) injected failures, each restarting from the newest valid
    checkpoint; the losses of replayed steps appear again, as the
    reference's do.  Without ``ckpt_dir`` ``fail_at`` is not read, as in
    the reference."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    if smoke:
        cfg = reduced(cfg)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    model = Model(cfg, device=dev)
    # smoke-scale LR: tiny models on tiny data learn fastest around 3e-3
    ocfg = adamw.AdamWConfig(lr=3e-3, total_steps=steps,
                             warmup_steps=max(1, steps // 10))
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq_len,
                                  global_batch=batch, seed=seed))
    started = not torch.distributed.is_initialized()
    try:
        step_fn = make_train_step(model, make_host_mesh(device_type=dev.type),
                                  ocfg, grad_compression=grad_compression)
        return _loop(cfg, model, data, step_fn, steps=steps, batch=batch,
                     seed=seed, dev=dev, ckpt_dir=ckpt_dir,
                     ckpt_every=ckpt_every, grad_compression=grad_compression,
                     fail_at=fail_at, log_every=log_every)
    finally:
        if started:
            # the one-rank group the mesh started is not left behind
            release_process_group()


def _loop(cfg, model, data, step_fn, *, steps, batch, seed, dev, ckpt_dir,
          ckpt_every, grad_compression, fail_at, log_every):
    """:func:`train`'s loop: plain, or :func:`run_with_restarts`."""

    def init_state() -> dict:
        params = tree_map(
            lambda p: p.to(dev),
            Model(cfg, device="cpu").init(torch.Generator("cpu")
                                          .manual_seed(seed)))
        return {"params": params, "opt": adamw.init(params),
                "err": compression.init_error_state(params)
                if grad_compression else {}}

    def make_batch(step: int) -> dict:
        b = data.batch(step, device=dev)
        if cfg.family in ("vlm", "audio"):
            b["ctx"] = context(cfg, batch, step, dev)
        return b

    if ckpt_dir is None:
        # plain loop, no fault tolerance
        state = init_state()
        losses = []
        for s in range(steps):
            t0 = time.perf_counter()
            state, loss = step_fn(state, make_batch(s))
            losses.append((s, float(loss)))
            if s % log_every == 0:
                print(f"step {s}: loss={losses[-1][1]:.4f} "
                      f"({time.perf_counter() - t0:.2f}s)", flush=True)
        return losses

    result = run_with_restarts(
        init_state=init_state, train_step=step_fn, data_batch=make_batch,
        total_steps=steps, ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
        fail_at=fail_at)
    for s, l in result.losses[::log_every]:
        print(f"step {s}: loss={l:.4f}", flush=True)
    print(f"restarts={result.restarts} stragglers={result.straggler_flags}")
    return result.losses


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-4b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--full", action="store_true",
                    help="full width (default: the reduced smoke config)")
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    # under torchrun (WORLD_SIZE > 1) the group of its ranks, from the
    # environment it sets: gloo on the host, NCCL on the cards
    launched = int(os.environ.get("WORLD_SIZE", "1")) > 1 \
        and not torch.distributed.is_initialized()
    if launched:
        dev = resolve_device(args.device)
        torch.distributed.init_process_group(
            "gloo" if dev.type == "cpu" else "nccl",
            device_id=None if dev.type == "cpu" else dev)
    try:
        losses = train(args.arch, steps=args.steps, smoke=not args.full,
                       seq_len=args.seq_len, batch=args.batch,
                       ckpt_dir=args.ckpt_dir,
                       grad_compression=args.grad_compression,
                       device=args.device)
    finally:
        if launched:
            torch.distributed.destroy_process_group()
    first, last = losses[0][1], losses[-1][1]
    print(f"loss: {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NOT improved'})")


if __name__ == "__main__":
    main()
