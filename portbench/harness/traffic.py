"""The one generator of every traffic mix: a closed loop of one client
sending one prompt a request, its lengths and tokens drawn from the seed.

A mix file's ``lengths`` give one cycle of prompt lengths, the same for
every seed:

* ``{"kind": "lognormal", "median", "sigma", "min", "max", "cycle"}``:
  the lognormal's quantiles at ``(i + 0.5) / cycle``, clipped to
  ``[min, max]``;
* ``{"kind": "fixed", "values": [...]}``: those lengths.

The seed orders each cycle anew (a fresh permutation a cycle), so two
seeds serve the same lengths in another order, and a window that serves
many cycles serves nearly the same mix whatever the seed.  Token ids are
drawn uniformly over the vocabulary into one pool on the device in
set-up; a request reads a slice of it at an offset drawn from the seed.
"""

from __future__ import annotations

import math
import statistics

import numpy as np
import torch

#: tokens in the pool a request's prompt is sliced from
POOL_TOKENS = 1 << 20


def rng(seed: int, stream: int) -> np.random.Generator:
    """A numpy generator for one use of ``seed`` (any whole number)."""
    return np.random.Generator(np.random.PCG64(
        np.random.SeedSequence([int(seed) % (1 << 64), stream])))


def torch_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for a ``torch.Generator`` from ``seed`` and a
    stream number."""
    return int(rng(seed, stream).integers(0, 1 << 63))


def cycle_lengths(traffic: dict) -> list[int]:
    """One cycle of the mix's prompt lengths, in ascending order."""
    spec = traffic["lengths"]
    if spec["kind"] == "fixed":
        return sorted(int(v) for v in spec["values"])
    if spec["kind"] == "lognormal":
        n, mu = int(spec["cycle"]), math.log(spec["median"])
        z = statistics.NormalDist()
        out = [math.exp(mu + spec["sigma"] * z.inv_cdf((i + 0.5) / n))
               for i in range(n)]
        return sorted(int(min(spec["max"], max(spec["min"], round(v))))
                      for v in out)
    raise ValueError(f"unknown length kind {spec['kind']!r}")


class Schedule:
    """The requests of one run, in order: ``next()`` gives ``(length,
    offset)``, the prompt being ``pool[offset:offset + length]``."""

    def __init__(self, traffic: dict, seed: int):
        self.base = cycle_lengths(traffic)
        self._rng = rng(seed, 1)
        self._queue: list[int] = []

    def __iter__(self):
        return self

    def __next__(self) -> tuple[int, int]:
        if not self._queue:
            self._queue = [self.base[i] for i in
                           self._rng.permutation(len(self.base))]
        length = self._queue.pop(0)
        return length, int(self._rng.integers(0, POOL_TOKENS - length + 1))

    def take(self, n: int) -> list[tuple[int, int]]:
        return [next(self) for _ in range(n)]


def token_pool(seed: int, vocab: int, device) -> torch.Tensor:
    """``POOL_TOKENS`` token ids, uniform over ``[0, vocab)``, drawn on
    ``device`` from the seed in one call."""
    g = torch.Generator(device=device)
    g.manual_seed(torch_seed(seed, 2))
    return torch.randint(0, vocab, (POOL_TOKENS,), generator=g,
                         device=device, dtype=torch.int64)
