"""Deterministic synthetic token pipeline: the port of the reference's
``repro.data.pipeline``, its mesh placement (:func:`shard_batch`) on
``torch.distributed`` ranks.

An indexable, stateless source (step -> global batch), so any worker can
reproduce any batch.  The "dataset" is a seeded Markov-ish token stream
drawn with numpy's ``default_rng`` exactly as the reference draws it, so
its tokens are the reference's bit for bit; only the last step, to
tensors on ``device``, is the port's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 1234


class SyntheticLM:
    """step-indexable synthetic LM data: ``batch(step)`` is pure."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        # a fixed low-rank "grammar": next-token logits = E @ D
        k = 16
        self._emit = rng.standard_normal((cfg.vocab, k)).astype(np.float32)
        self._trans = rng.standard_normal((k, cfg.vocab)).astype(np.float32)

    def batch(self, step: int, device="cuda") -> dict:
        """``{"tokens", "labels"}``: int32 (global_batch, seq_len) tensors
        on ``device`` (the card unless the caller asks for the CPU); the
        labels are the tokens shifted by one."""
        dev = resolve_device(device)
        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed * 1_000_003 + step)
        b, s = cfg.global_batch, cfg.seq_len
        toks = np.empty((b, s + 1), np.int32)
        toks[:, 0] = rng.integers(0, cfg.vocab, size=b)
        state = self._emit[toks[:, 0]]                     # (b, k)
        for t in range(1, s + 1):
            logits = state @ self._trans                   # (b, V)
            gumbel = rng.gumbel(size=logits.shape).astype(np.float32)
            # sharp transitions -> low-entropy, learnable stream
            nxt = np.argmax(logits * 2.0 + gumbel, axis=-1)
            toks[:, t] = nxt
            state = 0.7 * state + 0.3 * self._emit[nxt]
        return {"tokens": torch.from_numpy(toks[:, :-1].copy()).to(dev),
                "labels": torch.from_numpy(toks[:, 1:].copy()).to(dev)}

    def batches(self, start_step: int, device="cuda"):
        step = start_step
        while True:
            yield step, self.batch(step, device)
            step += 1


def shard_batch(batch: dict, mesh, batch_spec):
    """Place a batch (the same full tensors on every rank) onto ``mesh``
    with the training spec: every leaf a ``DTensor`` under ``batch_spec``
    (:mod:`repro_torch.parallel.sharding`)."""
    from repro_torch.models.tree import tree_map
    from repro_torch.parallel.sharding import distribute
    return tree_map(lambda x: distribute(x, mesh, batch_spec), batch)
