"""Tiered accuracy models for co-exploration, behind one protocol: the
port of :mod:`repro.explore.accuracy`.

``score(assign, layer_macs) -> (N,)`` is the relative quantization-noise
power, MAC-share weighted (0 = fp32 everywhere):

* **tier 0** (:class:`ProxyAccuracy`): the per-PE-type table of
  :func:`repro_torch.explore.objectives.mode_noise_table`;
* **tier 1** (:class:`CalibratedAccuracy`): per-layer, per-mode noise
  calibrated on model-zoo tensors
  (:func:`repro_torch.quant.calibrate.calibrate_model`), npz-cached;
* **tier 2**: tier-1 scoring during the search, then
  :func:`validate_elites` runs the Pareto elites through quantized
  forward passes (per-layer fake-quantized weights, ``Model.loss`` under
  ``torch.no_grad()``, so on the card attention goes through the flash
  kernel) and re-scores the front with the measured loss deltas.

The calibration and the validation run on a device (the card unless the
caller passes ``device="cpu"``); the tables, and so the scores, are float64
on the host.

Every model exposes ``state()`` / ``restore_state()`` / ``digest()``, so
a run can name the exact table it was scored with.  Scoring is numpy
with row-local reductions (never BLAS gemv), so a genome's score does not
depend on the batch it is scored in.
"""

from __future__ import annotations

import dataclasses
from typing import Protocol, runtime_checkable

import numpy as np

from repro_torch.core.pe import PEType

_TYPES = tuple(PEType)

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


class CalibratedAccuracy:
    """Tiers 1/2: per-layer noise from a calibrated zoo model.

    The calibration model's L_m layers are mapped proportionally onto a
    workload's L layers (layer ``i`` reads model row ``floor(i*L_m/L)``)
    so any workload depth shares one table.  ``device`` runs the
    calibration (a cache hit measures nothing); ``params`` calibrates
    those tensors instead of the seed's draw (uncached).
    """

    def __init__(self, spec: AccuracySpec, *, device="cuda", params=None):
        if spec.tier not in (1, 2):
            raise ValueError(f"CalibratedAccuracy needs tier 1/2 "
                             f"spec, got tier {spec.tier}")
        from repro_torch.quant.calibrate import calibrate_model
        self.spec = spec
        self.tier = spec.tier
        self.floor_db = spec.floor_db
        self._table = calibrate_model(
            spec.model, seed=spec.seed, percentile=spec.percentile,
            per_channel=spec.per_channel, cache_dir=spec.cache_dir,
            params=params, device=device)
        self._maps: dict[int, np.ndarray] = {}

    @property
    def calibration(self):
        """The underlying :class:`repro_torch.quant.calibrate.CalibrationTable`."""
        return self._table

    def layer_table(self, n_layers: int) -> np.ndarray:
        """(n_layers, T) view of the calibration table for one workload."""
        t = self._maps.get(n_layers)
        if t is None:
            lm = self._table.n_layers
            idx = (np.arange(n_layers, dtype=np.int64) * lm) // n_layers
            t = np.ascontiguousarray(self._table.table[idx])
            self._maps[n_layers] = t
        return t

    def score(self, assign, layer_macs) -> np.ndarray:
        a = np.asarray(assign)
        return _mac_weighted(self.layer_table(a.shape[1]), a, layer_macs)

    def state(self) -> dict[str, np.ndarray]:
        return self._table.state()

    def restore_state(self, state) -> None:
        from repro_torch.quant.calibrate import CalibrationTable
        s = self.spec
        self._table = CalibrationTable(
            model=s.model, seed=s.seed, percentile=s.percentile,
            per_channel=s.per_channel,
            **{k: np.asarray(v, dtype=np.float64) for k, v in state.items()})
        self._maps.clear()

    def digest(self) -> str:
        return self._table.digest()


def resolve_accuracy(accuracy, *, device="cuda") -> AccuracyModel:
    """Coerce ``None`` / string / :class:`AccuracySpec` / model instance
    to an :class:`AccuracyModel` (the single entry every consumer uses);
    a tier-1/2 spec calibrates on ``device``."""
    if accuracy is None:
        return ProxyAccuracy()
    if isinstance(accuracy, str):
        accuracy = AccuracySpec.parse(accuracy)
    if isinstance(accuracy, AccuracySpec):
        if accuracy.tier == 0:
            return ProxyAccuracy(accuracy)
        return CalibratedAccuracy(accuracy, device=device)
    if isinstance(accuracy, AccuracyModel):
        return accuracy
    raise TypeError(
        f"accuracy must be None, a spec string, an AccuracySpec, or an "
        f"AccuracyModel; got {type(accuracy).__name__}")


# ---------------------------------------------------------------------------
# Tier 2: quantized-forward elite validation
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EliteValidation:
    """Measured re-scoring of a Pareto front's elites (tier 2).

    ``loss_delta[k]`` is the eval-loss increase of elite
    ``elite_indices[k]``'s precision plan over the unquantized baseline,
    from a forward pass with per-layer fake-quantized weights.
    ``measured_objectives`` is the elite rows of the front matrix with the
    accuracy column (``accuracy_column``) replaced by the measured deltas
    (appended when the objective set has no accuracy column), and
    ``pareto_mask`` is Pareto membership over those rows.
    """

    model: str
    objectives: tuple
    elite_indices: np.ndarray
    baseline_loss: float
    quant_loss: np.ndarray
    loss_delta: np.ndarray
    measured_objectives: np.ndarray
    accuracy_column: int | None
    pareto_mask: np.ndarray

    def summary(self) -> dict:
        return {
            "model": self.model,
            "n_elites": int(len(self.elite_indices)),
            "baseline_loss": float(self.baseline_loss),
            "max_loss_delta": float(self.loss_delta.max()),
            "min_loss_delta": float(self.loss_delta.min()),
            "n_surviving": int(self.pareto_mask.sum()),
        }


def _accuracy_column(objectives) -> int | None:
    acc = {"accuracy_noise", "quant_noise",
           "worst_accuracy_noise", "worst_quant_noise",
           "mean_accuracy_noise", "mean_quant_noise"}
    for k, name in enumerate(objectives):
        if name in acc:
            return k
    return None


def validate_elites(result, accuracy, *, device="cuda",
                    params=None) -> EliteValidation:
    """Run the Pareto elites of a single-workload search through quantized
    forward passes and re-score the front with measured loss deltas (the
    tier-2 contract).

    Each elite's per-layer precision plan is mapped onto the calibration
    model's layers; every projection weight is fake-quantized with its
    layer's mode (the :data:`~repro_torch.quant.calibrate.PE_QUANT_SPECS`
    the tier-1 table was built from) and the model's loss is measured on a
    fixed synthetic eval batch under ``torch.no_grad()`` on ``device``.
    Deterministic: the seed's params (or ``params``, the calibration
    model's), a fixed batch, elites deduplicated by mapped plan.
    """
    import torch

    from repro_torch.core.device import resolve_device
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.explore.pareto import pareto_mask_k
    from repro_torch.models.model import Model
    from repro_torch.models.tree import tree_map
    from repro_torch.quant.calibrate import (PE_QUANT_SPECS, PROJ_NAMES,
                                            _per_channel,
                                            calibration_config,
                                            calibration_params)
    from repro_torch.quant.quantizers import quantize_dequantize

    dev = resolve_device(device)
    model = resolve_accuracy(accuracy, device=dev)
    spec = getattr(model, "spec", None)
    if spec is None or spec.tier == 0 or not spec.model:
        raise ValueError(
            "validate_elites needs a calibrated accuracy "
            "('calibrated:<model>' / 'measured:<model>' or a tier-1/2 "
            "AccuracySpec), not the tier-0 proxy")
    if getattr(result.space, "n_workloads", 1) > 1:
        raise ValueError(
            "tier-2 elite validation is single-workload only (a "
            "multi-workload genome has no single precision plan to "
            "run the model under)")

    _, assign = result.space.decode(result.genomes)
    n = assign.shape[0]
    if n > spec.max_elites:       # evenly spaced, deterministic subset
        sel = np.unique(np.round(
            np.linspace(0, n - 1, spec.max_elites)).astype(np.int64))
    else:
        sel = np.arange(n, dtype=np.int64)

    calib_cfg = calibration_config(spec.model)
    m = Model(calib_cfg, device=dev)
    params = calibration_params(calib_cfg, spec.seed, dev) \
        if params is None else tree_map(lambda p: p.to(dev), params)
    data = SyntheticLM(DataConfig(vocab=calib_cfg.vocab,
                                  seq_len=spec.eval_seq,
                                  global_batch=spec.eval_batch,
                                  seed=spec.seed + 2))
    batch = data.batch(0, device=dev)

    lm, lw = calib_cfg.n_layers, assign.shape[1]
    # model layer j runs under the plan of workload layer floor(j*lw/lm)
    wl_of = (np.arange(lm, dtype=np.int64) * lw) // lm

    def quantized_loss(plan: np.ndarray) -> float:
        layers = []
        for j, lp in enumerate(params["layers"]):
            wspec = PE_QUANT_SPECS[_TYPES[int(plan[j])]][0]
            if wspec is not None and spec.per_channel:
                wspec = _per_channel(wspec)
            layers.append({
                name: quantize_dequantize(w, wspec)
                if wspec is not None and name in PROJ_NAMES and w.dim() == 2
                else w for name, w in lp.items()})
        return float(m.loss({**params, "layers": layers}, batch,
                            train=False))

    plans = assign[sel][:, wl_of]                    # (M, lm) mode indices
    losses = np.zeros(len(sel), dtype=np.float64)
    seen: dict[bytes, float] = {}
    with torch.no_grad():
        baseline = float(m.loss(params, batch, train=False))
        for k, plan in enumerate(plans):
            key = plan.astype(np.int64).tobytes()
            if key not in seen:
                seen[key] = quantized_loss(plan)
            losses[k] = seen[key]

    delta = losses - baseline
    F = np.asarray(result.front_objectives, dtype=np.float64)[sel]
    col = _accuracy_column(result.objectives)
    measured = F.copy()
    if col is None:
        measured = np.concatenate([measured, delta[:, None]], axis=1)
    else:
        measured[:, col] = delta
    return EliteValidation(
        model=spec.model, objectives=tuple(result.objectives),
        elite_indices=sel, baseline_loss=baseline, quant_loss=losses,
        loss_delta=delta, measured_objectives=measured,
        accuracy_column=col, pareto_mask=pareto_mask_k(measured))
