"""QAPPA's PPA models: polynomial regression + k-fold CV model selection.

Port of :mod:`repro.core.ppa_model` (paper Sec. 3.3, Fig. 2): per PE
type, polynomial ridge models of power, area and throughput are fitted to
the synthesis oracle's reports, degree and ridge lambda chosen by k-fold
cross-validation, and the fitted models predict PPA for unseen configs
far faster than the oracle.

    configs --synthesize--> (power, area, perf) "actual"
    features(configs) --poly expand--> ridge fit, degree & lambda by k-fold CV

The features and the folds stay host numpy code
(:func:`feature_matrix`, :func:`kfold_indices` draw the reference's
folds from ``np.random.default_rng(seed)``); expansion, the fits, the CV
errors and the predictions are torch float64 on ``device``.  For one
degree the k folds x the lambdas are one batched
``torch.linalg.solve``; the selection is the reference's, strict ``<``
over (degree, lambda) in the same order.  Solves round differently from
numpy's LAPACK, so fitted values agree with the reference to float64
solve rounding, not bit for bit (``tests/test_torch_ppa_rtl.py``).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core.accelerator import AcceleratorConfig
from repro_torch.core.device import resolve_device
from repro_torch.core.pe import PEType
from repro_torch.core.synthesis import (SynthesisReport, synthesize,
                                        synthesize_many)

FEATURE_ORDER = (
    "num_pes", "ifmap_spad", "filter_spad", "psum_spad", "glb_kb",
    "dram_bw_gbps",
)

TARGETS = ("power_mw", "area_mm2", "throughput_gmacs")

_F64 = torch.float64


def feature_matrix(configs: Sequence[AcceleratorConfig]) -> np.ndarray:
    rows = []
    for c in configs:
        f = c.features()
        rows.append([f[k] for k in FEATURE_ORDER])
    return np.asarray(rows, dtype=np.float64)


def _combos(d: int, degree: int) -> np.ndarray:
    """Column recipes of the expansion: ``(P, degree)`` feature indices,
    ``d`` (a column of ones) padding the lower-degree terms."""
    rows = [[d] * degree]
    for deg in range(1, degree + 1):
        for combo in itertools.combinations_with_replacement(range(d), deg):
            rows.append(list(combo) + [d] * (degree - deg))
    return np.array(rows, dtype=np.int64)


def poly_expand(x, degree: int) -> torch.Tensor:
    """Polynomial feature expansion with interactions up to ``degree``
    (a numpy array is taken as a CPU tensor).  Each column is the product
    ``((1 * x_a) * x_b) * ...`` in the reference's order; multiplying by
    the padding ones is exact, so every column equals the reference's."""
    x = torch.as_tensor(x, dtype=_F64)
    n, d = x.shape
    ext = torch.cat([x, torch.ones((n, 1), dtype=_F64, device=x.device)],
                    dim=1)
    idx = torch.from_numpy(_combos(d, degree)).to(x.device)
    col = torch.ones((n, len(idx)), dtype=_F64, device=x.device)
    for j in range(degree):
        col = col * ext[:, idx[:, j]]
    return col


def _ridge_fit(phi: torch.Tensor, y: torch.Tensor,
               lam: float) -> torch.Tensor:
    a = phi.T @ phi + lam * torch.eye(phi.shape[1], dtype=_F64,
                                      device=phi.device)
    return torch.linalg.solve(a, phi.T @ y)


def kfold_indices(n: int, k: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    folds = np.array_split(perm, k)
    for i in range(k):
        val = folds[i]
        train = np.concatenate([folds[j] for j in range(k) if j != i])
        yield train, val


@dataclasses.dataclass
class PolyModel:
    """One fitted polynomial model (one PE type x one target); ``coef``
    lives on the device it was fitted on."""

    degree: int
    lam: float
    mean: np.ndarray
    std: np.ndarray
    coef: torch.Tensor
    log_target: bool
    cv_rmse: float

    def _predict_x(self, x_raw: torch.Tensor) -> torch.Tensor:
        dev = x_raw.device
        x = (x_raw - torch.from_numpy(self.mean).to(dev)) \
            / torch.from_numpy(self.std).to(dev)
        y = poly_expand(x, self.degree) @ self.coef.to(dev)
        return torch.exp(y) if self.log_target else y

    def predict(self, configs: Sequence[AcceleratorConfig],
                device: str | torch.device | None = None) -> np.ndarray:
        """Predictions for ``configs`` on ``device`` (default: the
        device the model was fitted on)."""
        dev = (self.coef.device if device is None
               else resolve_device(device))
        x_raw = torch.from_numpy(feature_matrix(configs)).to(dev)
        return self._predict_x(x_raw).cpu().numpy()


def fit_poly_model(
    configs: Sequence[AcceleratorConfig],
    y: np.ndarray,
    degrees: Sequence[int] = (1, 2, 3),
    lams: Sequence[float] = (1e-6, 1e-4, 1e-2),
    k: int = 5,
    log_target: bool = True,
    seed: int = 0,
    *,
    device: str | torch.device = "cuda",
) -> PolyModel:
    """Model selection over (degree, lambda) by k-fold CV (paper Sec. 3.3).

    Per degree, the ``k`` training folds' normal equations for every
    lambda are one batched solve on ``device``; the CV errors of all
    (degree, lambda) come back to the host once and the reference's
    strict-``<`` rule picks the model, which is then refitted on all
    points."""
    dev = resolve_device(device)
    x_raw = feature_matrix(configs)
    mean = x_raw.mean(0)
    std = x_raw.std(0) + 1e-12
    x = (torch.from_numpy(x_raw).to(dev) - torch.from_numpy(mean).to(dev)) \
        / torch.from_numpy(std).to(dev)
    yt = torch.as_tensor(np.asarray(y, dtype=np.float64)).to(dev)
    t = torch.log(torch.clamp(yt, min=1e-12)) if log_target else yt
    folds = [(torch.from_numpy(tr).to(dev), torch.from_numpy(va).to(dev))
             for tr, va in kfold_indices(len(x_raw), k, seed)]
    lam_t = torch.tensor(list(lams), dtype=_F64, device=dev)

    rmse_rows = []
    for degree in degrees:
        phi_full = poly_expand(x, degree)
        p = phi_full.shape[1]
        gram, rhs = [], []
        for tr, _ in folds:
            phi = phi_full[tr]
            gram.append(phi.T @ phi)
            rhs.append(phi.T @ t[tr])
        eye = torch.eye(p, dtype=_F64, device=dev)
        a = torch.stack(gram)[:, None] + lam_t[None, :, None, None] * eye
        b = torch.stack(rhs)[:, None, :, None].expand(-1, len(lams), -1, 1)
        coef = torch.linalg.solve(a, b)[..., 0]          # (k, n_lam, p)
        errs = torch.stack([
            torch.mean((phi_full[va] @ coef[f].T - t[va][:, None]) ** 2,
                       dim=0)
            for f, (_, va) in enumerate(folds)])          # (k, n_lam)
        rmse_rows.append(torch.sqrt(torch.mean(errs, dim=0)))
    rmse_all = torch.stack(rmse_rows).cpu().numpy()
    best = None
    for i, degree in enumerate(degrees):
        for j, lam in enumerate(lams):
            rmse = float(rmse_all[i, j])
            if best is None or rmse < best[0]:
                best = (rmse, degree, lam)
    rmse, degree, lam = best
    coef = _ridge_fit(poly_expand(x, degree), t, lam)
    return PolyModel(degree=degree, lam=lam, mean=mean, std=std, coef=coef,
                     log_target=log_target, cv_rmse=rmse)


@dataclasses.dataclass
class PPAModelSuite:
    """Per-PE-type polynomial models for power, area, and performance."""

    models: dict[PEType, dict[str, PolyModel]]

    def predict(self, cfg: AcceleratorConfig,
                device: str | torch.device | None = None
                ) -> dict[str, float]:
        ms = self.models[cfg.pe_type]
        return {t: float(ms[t].predict([cfg], device)[0]) for t in TARGETS}

    def predict_batch(self, configs: Sequence[AcceleratorConfig],
                      device: str | torch.device | None = None
                      ) -> dict[str, np.ndarray]:
        """Prediction for a mixed-PE-type batch: one model evaluation per
        (PE type x target) on the device, scattered back in input order
        and copied to the host once."""
        n = len(configs)
        dev = None if device is None else resolve_device(device)
        out = None
        for pe_type, ms in self.models.items():
            idx = [i for i, c in enumerate(configs) if c.pe_type == pe_type]
            if not idx:
                continue
            d = ms[TARGETS[0]].coef.device if dev is None else dev
            if out is None:
                out = torch.empty((len(TARGETS), n), dtype=_F64, device=d)
            x_raw = torch.from_numpy(
                feature_matrix([configs[i] for i in idx])).to(d)
            rows = torch.from_numpy(np.asarray(idx, dtype=np.int64)).to(d)
            for j, t in enumerate(TARGETS):
                out[j, rows] = ms[t]._predict_x(x_raw).to(out.device)
        if out is None:
            return {t: np.empty(n, dtype=np.float64) for t in TARGETS}
        host = out.cpu().numpy()
        return {t: host[j] for j, t in enumerate(TARGETS)}


def fit_ppa_suite(
    configs_by_type: dict[PEType, Sequence[AcceleratorConfig]],
    oracle: Callable[[AcceleratorConfig], SynthesisReport] = synthesize,
    *,
    device: str | torch.device = "cuda",
    **fit_kwargs,
) -> tuple[PPAModelSuite, dict]:
    """Fit the full suite on ``device`` and return (suite, accuracy stats
    per model).  The oracle runs on the host (vectorized through the
    report cache by default)."""
    dev = resolve_device(device)
    suite: dict[PEType, dict[str, PolyModel]] = {}
    stats: dict[str, dict[str, float]] = {}
    for pe_type, configs in configs_by_type.items():
        if oracle is synthesize:   # default flow: vectorized + report cache
            reports = synthesize_many(configs)
        else:
            reports = [oracle(c) for c in configs]
        actual = {t: np.array([getattr(r, t) for r in reports])
                  for t in TARGETS}
        x_raw = torch.from_numpy(feature_matrix(configs)).to(dev)
        suite[pe_type] = {}
        for target in TARGETS:
            m = fit_poly_model(configs, actual[target], device=dev,
                               **fit_kwargs)
            suite[pe_type][target] = m
            act = torch.from_numpy(actual[target]).to(dev)
            resid = m._predict_x(x_raw) - act
            ss_res = float(torch.sum(resid ** 2))
            ss_tot = float(torch.sum((act - act.mean()) ** 2))
            stats[f"{pe_type.value}/{target}"] = {
                "r2": 1.0 - ss_res / max(ss_tot, 1e-12),
                "mape": float(torch.mean(
                    torch.abs(resid) / torch.clamp(act, min=1e-12))),
                "degree": m.degree, "lam": m.lam, "cv_rmse": m.cv_rmse,
                "n": len(configs),
            }
    return PPAModelSuite(models=suite), stats
