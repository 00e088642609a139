"""The training driver: the port of :mod:`repro.launch.train` on one
card.

Wires config -> :class:`~repro_torch.models.model.Model` -> a train step
(``Model.loss`` under QAT, its gradient by autograd, then
:func:`repro_torch.optim.adamw.update`) -> the synthetic data pipeline.
The reference's mesh and activation sharding have no counterpart on one
card.  Under grad every attention runs the plain route (the kernels have
no backward, ``kernels/ops.py``), and the projections of a quantized
policy are fake-quantized float products (``quant/qlinear.qdot``), so a
training step launches none of the port's kernels.

Not ported yet (ROADMAP A.8): the checkpointed, restarting loop
(``ckpt_dir=``, ``fail_at=``: ``runtime.fault_tolerance.run_with_restarts``
and the pytree checkpoints) and int8 gradient compression
(``grad_compression=True``: ``parallel/compression.py``); both raise.

Usage (the CPU at reduced width; on the card at full width drop
``--device cpu`` and add ``--full``)::

  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \\
      --device cpu --steps 20
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.core.device import resolve_device
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models.model import Model
from repro_torch.models.tree import tree_map
from repro_torch.optim import adamw

# the reference's knobs that wait for the rest of ROADMAP A.8
_NOT_PORTED = {
    "ckpt_dir": "the checkpointed, restarting loop "
                "(runtime.fault_tolerance.run_with_restarts and the pytree "
                "checkpoints) is not ported yet (ROADMAP A.8)",
    "grad_compression": "int8 gradient compression (parallel/compression"
                        ".py) is not ported yet (ROADMAP A.8)",
}


def make_train_step(model: Model, ocfg: adamw.AdamWConfig, *,
                    grad_compression: bool = False):
    """``step(state, batch) -> (state, loss)`` with ``state = {"params",
    "opt"}``: the QAT loss, its gradient with respect to every param leaf
    (zero for a leaf the loss does not reach, as ``jax.grad`` gives) and
    one AdamW update.  The new state holds new tensors; the caller drops
    the old one."""
    if grad_compression:
        raise ValueError(f"grad_compression=True: "
                         f"{_NOT_PORTED['grad_compression']}")

    def train_step(state, batch):
        params = tree_map(
            lambda p: p.detach().requires_grad_(True), state["params"])
        loss = model.loss(params, batch)
        loss.backward()
        grads = tree_map(
            lambda p: p.grad if p.grad is not None else torch.zeros_like(p),
            params)
        new_params, opt, _ = adamw.update(ocfg, grads, state["opt"],
                                          params)
        return {"params": new_params, "opt": opt}, loss.detach()

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
          grad_compression: bool = False,
          fail_at: dict | None = None, log_every: int = 5, seed: int = 0,
          device="cuda") -> list[tuple[int, float]]:
    """``steps`` AdamW steps of ``arch`` (reduced width with ``smoke``,
    else full) on ``SyntheticLM`` batches; returns ``[(step, loss)]``.
    The params are drawn on the CPU from ``torch.Generator("cpu")
    .manual_seed(seed)`` and moved to ``device`` (the card unless the
    caller asks for the CPU), so both devices start from one draw."""
    for name, value in (("ckpt_dir", ckpt_dir), ("fail_at", fail_at)):
        if value is not None:
            raise ValueError(f"{name}=: {_NOT_PORTED['ckpt_dir']}")
    dev = resolve_device(device)
    cfg = get_config(arch)
    if smoke:
        cfg = reduced(cfg)
    model = Model(cfg, device=dev)
    # smoke-scale LR: tiny models on tiny data learn fastest around 3e-3
    ocfg = adamw.AdamWConfig(lr=3e-3, total_steps=steps,
                             warmup_steps=max(1, steps // 10))
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq_len,
                                  global_batch=batch, seed=seed))
    step_fn = make_train_step(model, ocfg,
                              grad_compression=grad_compression)
    params = tree_map(
        lambda p: p.to(dev),
        Model(cfg, device="cpu").init(torch.Generator("cpu")
                                      .manual_seed(seed)))
    state = {"params": params, "opt": adamw.init(params)}
    del params

    def make_batch(step: int) -> dict:
        b = data.batch(step, device=dev)
        if cfg.family in ("vlm", "audio"):
            b["ctx"] = context(cfg, batch, step, dev)
        return b

    losses = []
    for s in range(steps):
        t0 = time.perf_counter()
        state, loss = step_fn(state, make_batch(s))
        losses.append((s, float(loss)))
        if s % log_every == 0:
            print(f"step {s}: loss={losses[-1][1]:.4f} "
                  f"({time.perf_counter() - t0:.2f}s)", flush=True)
    return losses


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-4b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--full", action="store_true",
                    help="full width (default: the reduced smoke config)")
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    losses = train(args.arch, steps=args.steps, smoke=not args.full,
                   seq_len=args.seq_len, batch=args.batch,
                   device=args.device)
    first, last = losses[0][1], losses[-1][1]
    print(f"loss: {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NOT improved'})")


if __name__ == "__main__":
    main()
