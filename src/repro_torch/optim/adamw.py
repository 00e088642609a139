"""AdamW with a cosine schedule and global-norm clipping: the port of
:mod:`repro.optim.adamw`, on the port's params (dicts and lists of
per-layer dicts of tensors).

The moments are float32 whatever the model's policy.  Two points of the
reference's layout are kept in the port's:

* **The decay set.**  The reference decays every leaf with ``ndim >= 2``
  of its *stacked* tree, where a per-layer leaf carries the layer axis.
  So every leaf of the ``layers``, ``cross_layers`` and
  ``encoder_layers`` stacks is decayed, the per-layer norm scales and
  SSM vectors included, and so is ``embed``; ``final_norm`` and the
  vectors of the hybrid's unstacked ``shared`` block are not.  The port
  decays by that rank (:func:`decayed`), not by its own.
* **The leaf order.**  :func:`global_norm` sums float32 squares leaf by
  leaf in the reference's ``jax.tree.leaves`` order (sorted keys; a
  stacked leaf's layers summed one after another).

The step counter is a host integer; the schedule and the bias
corrections are float32, as the reference computes them.  On placed
trees (``DTensor`` leaves, :func:`repro_torch.launch.train.make_train_step`
on a mesh) every update is elementwise on each rank's block and keeps
its leaf's placements; only :func:`global_norm` meets across ranks.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.models.tree import tree_map
from repro_torch.parallel.sharding import reduce_partial

#: the param-tree keys whose lists the reference stacks on a layer axis
STACKED = ("layers", "cross_layers", "encoder_layers")


class AdamWState(NamedTuple):
    step: int                # updates applied so far
    mu: dict                 # first moments (param tree)
    nu: dict                 # second moments


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    clip_norm: float = 1.0


def leaves(tree) -> list[tuple[str, torch.Tensor, bool]]:
    """``(path, leaf, stacked)`` in the reference's leaf order: keys
    sorted, a stacked list's leaf ``name`` layer after layer (the
    reference's one ``(L, ...)`` leaf); ``stacked`` where the reference
    carries a layer axis."""
    out = []
    for key in sorted(tree):
        v = tree[key]
        if isinstance(v, torch.Tensor):
            out.append((key, v, False))
        elif isinstance(v, dict):
            out += [(f"{key}/{p}", t, s) for p, t, s in leaves(v)]
        elif key in STACKED:
            for name in sorted(v[0]):
                out += [(f"{key}/{l}/{name}", lp[name], True)
                        for l, lp in enumerate(v)]
        else:
            raise TypeError(f"param tree: {key!r} is a "
                            f"{type(v).__name__}, not a stacked list")
    return out


def decayed(params) -> dict[str, torch.Tensor]:
    """The leaves that get weight decay, by path: rank >= 2 in the
    reference's stacked layout (a stacked leaf counts its layer axis).
    :func:`update` decays exactly these."""
    return {path: p for path, p, stacked in leaves(params)
            if p.dim() + stacked >= 2}


def zeros_f32(p: torch.Tensor) -> torch.Tensor:
    """float32 zeros in ``p``'s shape and device, and its placements
    where ``p`` is a ``DTensor`` (read from ``p`` alone where it is not,
    so a fake tensor of another mode serves)."""
    if hasattr(p, "placements"):
        return torch.zeros_like(p, dtype=torch.float32)
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def init(params) -> AdamWState:
    """Zero moments (:func:`zeros_f32`), placed as their params."""
    return AdamWState(step=0, mu=tree_map(zeros_f32, params),
                      nu=tree_map(zeros_f32, params))


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def schedule(cfg: AdamWConfig, step: int) -> torch.Tensor:
    """The learning rate at ``step`` (linear warm-up, cosine decay to
    ``min_lr_ratio``), a float32 scalar on the host."""
    s = _f32(step)
    warm = torch.clamp(_f32(step + 1) / _f32(max(1, cfg.warmup_steps)),
                       max=1.0)
    t = torch.clamp((s - _f32(cfg.warmup_steps))
                    / _f32(max(1, cfg.total_steps - cfg.warmup_steps)),
                    0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(_f32(math.pi) * t))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the float32 sum of squares of every leaf, leaf by leaf in
    the reference's order (a sharded leaf's sum all-reduced as it is
    taken)."""
    sq = 0
    for _, g, _ in leaves(tree):
        sq = sq + reduce_partial(torch.sum(torch.square(g.to(torch.float32))))
    return torch.sqrt(sq)


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    factor = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g * factor).to(g.dtype), grads), norm


@torch.no_grad()
def update(cfg: AdamWConfig, grads, state: AdamWState, params):
    """Returns ``(new_params, new_state, metrics)``; ``metrics`` holds the
    step's ``lr`` and the pre-clip ``grad_norm``."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    step = state.step + 1
    lr = schedule(cfg, state.step)
    b1c = 1 - torch.pow(_f32(cfg.b1), _f32(step))
    b2c = 1 - torch.pow(_f32(cfg.b2), _f32(step))

    decay = {id(p) for p in decayed(params).values()}

    def upd(p, g, m, v):
        gf = g.to(torch.float32)
        m = cfg.b1 * m + (1 - cfg.b1) * gf
        v = cfg.b2 * v + (1 - cfg.b2) * gf * gf
        step_ = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if id(p) in decay:       # decoupled weight decay
            step_ = step_ + cfg.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * step_).to(p.dtype), m, v

    out = tree_map(upd, params, grads, state.mu, state.nu)
    return tree_map(lambda t: t[0], out), AdamWState(
        step=step, mu=tree_map(lambda t: t[1], out),
        nu=tree_map(lambda t: t[2], out)), {"lr": lr, "grad_norm": gnorm}
