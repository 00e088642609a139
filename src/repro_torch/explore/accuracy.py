"""Accuracy models for co-exploration, behind one protocol.

Port of tier 0 of :mod:`repro.explore.accuracy`: ``score(assign,
layer_macs) -> (N,)`` is the relative quantization-noise power, MAC-share
weighted (0 = fp32 everywhere).  :class:`ProxyAccuracy` scores with the
per-PE-type table of :func:`repro_torch.explore.objectives.mode_noise_table`.

Tiers 1 and 2 calibrate on model-zoo tensors and run quantized forward
passes; they are not ported yet (ROADMAP A.7), so their specs parse but
:func:`resolve_accuracy` refuses them.

Every model exposes ``state()`` / ``restore_state()`` / ``digest()``, so
a run can name the exact table it was scored with.  Scoring is numpy
with row-local reductions (never BLAS gemv), so a genome's score does not
depend on the batch it is scored in.
"""

from __future__ import annotations

import dataclasses
from typing import Protocol, runtime_checkable

import numpy as np

_TIER_NAMES = {0: "proxy", 1: "calibrated", 2: "measured"}


@runtime_checkable
class AccuracyModel(Protocol):
    """What the exploration stack needs from an accuracy tier."""

    tier: int
    floor_db: float | None

    def score(self, assign: np.ndarray,
              layer_macs: np.ndarray) -> np.ndarray: ...

    def state(self) -> dict[str, np.ndarray]: ...

    def restore_state(self, state: dict[str, np.ndarray]) -> None: ...

    def digest(self) -> str: ...


@dataclasses.dataclass(frozen=True)
class AccuracySpec:
    """Declarative accuracy-tier request.

    ``tier`` 0 needs no model; tiers 1/2 name a zoo config ``model``.
    ``floor_db`` is the minimum acceptable MAC-weighted SQNR, a scalar or
    (multi-workload) one value per workload, valid at any tier.  The
    remaining fields only matter at tiers 1/2.
    """

    tier: int = 0
    model: str | None = None
    seed: int = 0
    percentile: float = 99.9
    per_channel: bool = True
    floor_db: float | tuple[float, ...] | None = None
    cache_dir: str | None = None
    eval_batch: int = 4
    eval_seq: int = 64
    max_elites: int = 16

    def __post_init__(self):
        if self.tier not in (0, 1, 2):
            raise ValueError(f"tier must be 0, 1, or 2; got {self.tier}")
        if self.tier == 0 and self.model is not None:
            raise ValueError(
                "tier 0 is the synthetic proxy and takes no model=; use "
                "tier=1/2 (or 'calibrated:<model>' / 'measured:<model>')")
        if self.tier >= 1 and not self.model:
            raise ValueError(
                f"tier {self.tier} calibrates on a zoo model; pass "
                f"model= (e.g. 'mamba2-130m')")
        if self.floor_db is not None:
            fl = (float(self.floor_db) if np.ndim(self.floor_db) == 0
                  else tuple(float(x) for x in np.asarray(self.floor_db)))
            if np.any(np.asarray(fl) <= 0):
                raise ValueError(f"floor_db must be > 0 dB, "
                                 f"got {self.floor_db}")
            object.__setattr__(self, "floor_db", fl)
        if self.tier == 2 and self.max_elites < 1:
            raise ValueError("max_elites must be >= 1")

    @classmethod
    def parse(cls, text: str) -> "AccuracySpec":
        """``"proxy"`` | ``"calibrated:<model>"`` | ``"measured:<model>"``."""
        kind, _, model = text.partition(":")
        tiers = {v: k for k, v in _TIER_NAMES.items()}
        if kind not in tiers or (kind == "proxy") != (not model):
            raise ValueError(
                f"bad accuracy spec {text!r}: expected 'proxy', "
                f"'calibrated:<model>', or 'measured:<model>'")
        return cls(tier=tiers[kind], model=model or None)


def _mac_weighted(table_rows: np.ndarray, assign: np.ndarray,
                  layer_macs: np.ndarray) -> np.ndarray:
    """MAC-share weighted noise with a per-layer ``(L, T)`` table, as a
    row-local axis-1 reduction."""
    a = np.asarray(assign, dtype=np.int64)
    macs = np.asarray(layer_macs, dtype=np.float64)
    wts = macs / macs.sum()
    rows = np.arange(a.shape[1])[None, :]
    return (table_rows[rows, a] * wts).sum(axis=1)


def _table_digest(tier: int, table: np.ndarray) -> str:
    from repro_torch.core.confighash import digest_words, f64_words
    lo, hi = f64_words(np.ascontiguousarray(table).ravel())
    words = [np.uint32(tier)] + list(lo) + list(hi)
    with np.errstate(over="ignore"):
        return "".join(f"{int(w):08x}" for w in digest_words(words))


class ProxyAccuracy:
    """Tier 0: the synthetic per-PE-type SQNR proxy.

    Unpinned instances delegate to
    :func:`repro_torch.explore.objectives.quant_noise`; ``restore_state``
    pins an exact ``(T,)`` table.
    """

    tier = 0

    def __init__(self, spec: AccuracySpec | None = None):
        self.spec = spec or AccuracySpec()
        self.floor_db = self.spec.floor_db
        self._pinned: np.ndarray | None = None

    def _table(self) -> np.ndarray:
        if self._pinned is not None:
            return self._pinned
        from repro_torch.explore.objectives import mode_noise_table
        return np.asarray(mode_noise_table(), dtype=np.float64)

    def score(self, assign, layer_macs) -> np.ndarray:
        if self._pinned is None:
            from repro_torch.explore.objectives import quant_noise
            return quant_noise(assign, layer_macs)
        macs = np.asarray(layer_macs, dtype=np.float64)
        wts = macs / macs.sum()
        a = np.asarray(assign, dtype=np.int64)
        return (self._pinned[a] * wts).sum(axis=1)

    def state(self) -> dict[str, np.ndarray]:
        return {"mode_table": self._table().copy()}

    def restore_state(self, state) -> None:
        self._pinned = np.asarray(state["mode_table"], dtype=np.float64)

    def digest(self) -> str:
        return _table_digest(self.tier, self._table())


def resolve_accuracy(accuracy) -> AccuracyModel:
    """Coerce ``None`` / string / :class:`AccuracySpec` / model instance
    to an :class:`AccuracyModel`; tiers 1/2 raise (ROADMAP A.7)."""
    if accuracy is None:
        return ProxyAccuracy()
    if isinstance(accuracy, str):
        accuracy = AccuracySpec.parse(accuracy)
    if isinstance(accuracy, AccuracySpec):
        if accuracy.tier == 0:
            return ProxyAccuracy(accuracy)
        raise ValueError(
            f"accuracy tier {accuracy.tier} ({_TIER_NAMES[accuracy.tier]}:"
            f"{accuracy.model}) calibrates on model tensors, which the "
            f"port does not have yet (ROADMAP A.7); use the tier-0 proxy")
    if isinstance(accuracy, AccuracyModel):
        return accuracy
    raise TypeError(
        f"accuracy must be None, a spec string, an AccuracySpec, or an "
        f"AccuracyModel; got {type(accuracy).__name__}")
