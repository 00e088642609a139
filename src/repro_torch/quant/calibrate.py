"""Tier-1 accuracy calibration: per-layer, per-mode quantization noise
measured on model-zoo tensors.  The port of :mod:`repro.quant.calibrate`.

For a named config (mamba2-130m, phi4-mini-3.8b, ...) the calibrator
draws the parameters at full depth and reduced width (the reference's
design: per-layer structure kept, init cheap), runs every projection
weight of every layer through the fake quantizers of each PE type
(:data:`PE_QUANT_SPECS`) on the device, samples activations from the
embedding rows of a fixed synthetic token batch, and records

* a per-layer, per-PE-type relative noise-power table (weight noise +
  activation noise, per-channel or per-tensor scales),
* per-layer statistics of the weights (absmax, percentile, std).

The quantize-dequantize runs on the device; the noise ratios, shares and
sums are taken in float64 numpy on the host in the reference's order, so
on the CPU a table fed the reference's tensors equals the reference's bit
for bit.

Weights.  The reference draws them with ``m.init(jax.random.key(seed))``,
which the port cannot reproduce; the port draws its own on the CPU with
``Model(calib_cfg, device="cpu").init(torch.Generator("cpu")
.manual_seed(seed))`` (so a table does not depend on the device that
measured it) and moves them to the device.  ``params=`` feeds any
tensors instead (the tests feed the reference's, converted).

Cache.  Tables are cached to ``.npz`` files keyed by a confighash digest
of the spec, under the port's own directory (``$REPRO_TORCH_CALIB_CACHE``
or ``~/.cache/repro-qappa-torch/calibration``) and with a port word in
the key, so a table from torch-drawn weights is never read as the
reference's, nor the other way round.  Tables measured on injected
params are not cached.  The reference's analytic fallback (a proxy table
when jax is unusable) has no counterpart: a failed measurement raises.

Only the decoder ``layers`` feed the table: the hybrid's ``shared``
block, the cross and encoder layers and the 3-D expert stacks are left
out, as in the reference.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
import warnings
import zipfile

import numpy as np
import torch

from repro_torch.core.pe import PEType
from repro_torch.models.tree import tree_map
from repro_torch.quant.quantizers import FakeQuantSpec

CALIB_VERSION = 1

#: the port's word in every calibration key and digest (b"trch")
PORT_WORD = int.from_bytes(b"trch", "little")

_TYPES = tuple(PEType)

# mode -> (weight spec, activation spec); None = native precision.  The
# tier-0 noise table (explore/objectives.py) and the tier-1 calibrator
# here both read it.
PE_QUANT_SPECS: dict[PEType, tuple[FakeQuantSpec | None,
                                   FakeQuantSpec | None]] = {
    PEType.FP32: (None, None),
    PEType.INT16: (FakeQuantSpec("int", 16), FakeQuantSpec("int", 16)),
    PEType.LIGHTPE1: (FakeQuantSpec("pow2"), FakeQuantSpec("int", 8)),
    PEType.LIGHTPE2: (FakeQuantSpec("pow2_2term"), FakeQuantSpec("int", 8)),
}

# the projections that serving quantizes (Model.quantize_params)
PROJ_NAMES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
              "wq_x", "wk_img", "wv_img", "wo_x", "in_proj", "out_proj")

_CACHE_STATS = {"hits": 0, "misses": 0}


def calibration_cache_stats() -> dict[str, int]:
    """Copy of the process-wide npz-cache hit/miss counters."""
    return dict(_CACHE_STATS)


def reset_calibration_cache_stats() -> None:
    _CACHE_STATS["hits"] = 0
    _CACHE_STATS["misses"] = 0


def calibration_cache_dir() -> pathlib.Path:
    """Cache root: ``$REPRO_TORCH_CALIB_CACHE`` or
    ``~/.cache/repro-qappa-torch/calibration``."""
    env = os.environ.get("REPRO_TORCH_CALIB_CACHE")
    if env:
        return pathlib.Path(env)
    return pathlib.Path.home() / ".cache" / "repro-qappa-torch" / \
        "calibration"


def _rel_noise(v64: np.ndarray, q: torch.Tensor) -> float:
    """E[(v - qdq(v))^2] / E[v^2], accumulated in float64 on the host."""
    q64 = q.detach().cpu().numpy().astype(np.float64)
    return float(np.mean((v64 - q64) ** 2) / np.mean(v64 ** 2))


def _per_channel(spec: FakeQuantSpec) -> FakeQuantSpec:
    """Per-output-channel variant of a weight spec (axis 0 of (d_in,
    d_out)), the qlinear serve / QAT convention."""
    return dataclasses.replace(spec, axis=0, per_channel=True)


@dataclasses.dataclass(frozen=True)
class CalibrationTable:
    """Per-layer, per-PE-type noise table for one calibrated model.

    ``table[l, t]`` is the relative quantization-noise power (weight +
    activation) layer ``l`` pays under PE type ``tuple(PEType)[t]``, in
    the units of the tier-0 proxy table.  ``per_tensor_table`` is the
    per-tensor variant whichever granularity ``table`` was built with.
    """

    model: str
    seed: int
    percentile: float
    per_channel: bool
    table: np.ndarray             # (L, T) float64
    per_tensor_table: np.ndarray  # (L, T) float64
    act_noise: np.ndarray         # (T,) float64, shared activation sample
    absmax: np.ndarray            # (L,) float64
    scale_pctl: np.ndarray        # (L,) float64  |w| percentile per layer
    std: np.ndarray               # (L,) float64

    @property
    def n_layers(self) -> int:
        return self.table.shape[0]

    def digest(self) -> str:
        """Content digest (spec words + the tables' words), pinned into
        search checkpoints so that a resumed run refuses a different
        calibration."""
        from repro_torch.core.confighash import digest_words, f64_words
        words = list(_spec_words(self.model, self.seed, self.percentile,
                                 self.per_channel))
        for arr in (self.table, self.per_tensor_table, self.act_noise):
            lo, hi = f64_words(np.ascontiguousarray(arr).ravel())
            words += list(lo) + list(hi)
        # scalar words wrap in numpy-scalar arithmetic: silence the
        # (intended) uint32 overflow warning
        with np.errstate(over="ignore"):
            return "".join(f"{int(w):08x}" for w in digest_words(words))

    def state(self) -> dict[str, np.ndarray]:
        """Arrays for checkpoint snapshots and the npz cache."""
        return {"table": self.table,
                "per_tensor_table": self.per_tensor_table,
                "act_noise": self.act_noise,
                "absmax": self.absmax,
                "scale_pctl": self.scale_pctl,
                "std": self.std}


def _spec_words(model: str, seed: int, percentile: float,
                per_channel: bool):
    """Scalar uint32 words identifying a calibration spec: the
    reference's words and :data:`PORT_WORD`."""
    from repro_torch.core.confighash import f64_words
    raw = model.encode("utf-8")
    raw += b"\0" * (-len(raw) % 4)
    name_words = list(np.frombuffer(raw, dtype=np.uint32)) if raw else []
    plo, phi = f64_words(np.array([percentile]))
    return name_words + [np.uint32(len(raw)),
                         np.uint32(seed & 0xFFFFFFFF), plo[0], phi[0],
                         np.uint32(bool(per_channel)),
                         np.uint32(CALIB_VERSION), np.uint32(PORT_WORD)]


def calibration_key(model: str, *, seed: int = 0, percentile: float = 99.9,
                    per_channel: bool = True) -> str:
    """Hex cache key for a calibration spec (confighash digest)."""
    from repro_torch.core.confighash import digest_words
    with np.errstate(over="ignore"):
        d = digest_words(_spec_words(model, seed, percentile, per_channel))
        return "".join(f"{int(w):08x}" for w in d)


def calibration_params(calib_cfg, seed: int, device) -> dict:
    """The port's draw of a calibration model's params: on the CPU from
    ``torch.Generator("cpu").manual_seed(seed)``, then on ``device``."""
    from repro_torch.models.model import Model
    params = Model(calib_cfg, device="cpu").init(
        torch.Generator("cpu").manual_seed(seed))
    return tree_map(lambda p: p.to(device), params)


def _collect_layer_weights(params: dict) -> list[list[torch.Tensor]]:
    """Per-layer list of the (d_in, d_out) projection weights of
    ``params['layers']``, in each layer's sorted leaf names (the
    reference's order over its stacked tree); 3-D leaves stay out."""
    per_layer = []
    for lp in params["layers"]:
        ws = []
        for name in sorted(lp):
            if name in PROJ_NAMES and lp[name].dim() == 2:
                ws.append(lp[name])
        per_layer.append(ws)
    return per_layer


def calibration_config(model: str):
    """The calibration model of zoo config ``model``: full depth, reduced
    width (``reduced(cfg, n_layers=cfg.n_layers)``)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced
    cfg = get_config(model)
    return reduced(cfg, n_layers=cfg.n_layers)


def _measure(model: str, seed: int, percentile: float, per_channel: bool,
             *, params: dict | None = None,
             device="cuda") -> CalibrationTable:
    from repro_torch.core.device import resolve_device
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.quant.quantizers import quantize_dequantize

    dev = resolve_device(device)
    calib_cfg = calibration_config(model)
    params = calibration_params(calib_cfg, seed, dev) if params is None \
        else tree_map(lambda p: p.to(dev), params)
    layers = _collect_layer_weights(params)
    if len(layers) != calib_cfg.n_layers or not any(layers):
        raise ValueError(
            f"model {model!r}: expected {calib_cfg.n_layers} layers with "
            f"projection weights to calibrate, got "
            f"{[len(ws) for ws in layers]}")

    # one shared activation sample: embedding rows of a fixed token batch
    data = SyntheticLM(DataConfig(vocab=calib_cfg.vocab, seq_len=64,
                                  global_batch=4, seed=seed + 1))
    toks = data.batch(0, device="cpu")["tokens"].numpy().ravel()
    embed = params["embed"].detach().cpu().numpy().astype(np.float64)
    act64 = embed[toks].ravel()
    act32 = torch.from_numpy(act64.astype(np.float32)).to(dev)

    T, L = len(_TYPES), calib_cfg.n_layers
    act_noise = np.zeros(T, dtype=np.float64)
    for t, (_, aspec) in PE_QUANT_SPECS.items():
        if aspec is not None:
            act_noise[_TYPES.index(t)] = _rel_noise(
                act64, quantize_dequantize(act32, aspec))

    w_pc = np.zeros((L, T), dtype=np.float64)
    w_pt = np.zeros((L, T), dtype=np.float64)
    absmax = np.zeros(L, dtype=np.float64)
    scale_pctl = np.zeros(L, dtype=np.float64)
    std = np.zeros(L, dtype=np.float64)
    for l, ws in enumerate(layers):
        w32s = [w.detach().to(torch.float32) for w in ws]
        w64s = [w.cpu().numpy().astype(np.float64) for w in w32s]
        flat = np.concatenate([w.ravel() for w in w64s])
        absmax[l] = np.abs(flat).max()
        scale_pctl[l] = np.percentile(np.abs(flat), percentile)
        std[l] = flat.std()
        counts = np.array([w.size for w in w64s], dtype=np.float64)
        shares = counts / counts.sum()
        for t, (wspec, _) in PE_QUANT_SPECS.items():
            ti = _TYPES.index(t)
            if wspec is None:
                continue
            for w32, w64, share in zip(w32s, w64s, shares):
                w_pc[l, ti] += share * _rel_noise(
                    w64, quantize_dequantize(w32, _per_channel(wspec)))
                w_pt[l, ti] += share * _rel_noise(
                    w64, quantize_dequantize(w32, wspec))

    table = (w_pc if per_channel else w_pt) + act_noise[None, :]
    return CalibrationTable(
        model=model, seed=seed, percentile=percentile,
        per_channel=per_channel, table=table,
        per_tensor_table=w_pt + act_noise[None, :], act_noise=act_noise,
        absmax=absmax, scale_pctl=scale_pctl, std=std)


def calibrate_model(model: str, *, seed: int = 0, percentile: float = 99.9,
                    per_channel: bool = True, cache_dir=None,
                    refresh: bool = False, params: dict | None = None,
                    device="cuda") -> CalibrationTable:
    """Calibrated per-layer noise table for a zoo model, npz-cached.

    The cache file is named by :func:`calibration_key` of (model, seed,
    percentile, per_channel, :data:`CALIB_VERSION`, :data:`PORT_WORD`);
    ``refresh=True`` bypasses one entry, and an unreadable entry is
    re-measured with a warning.  ``params`` measures those tensors (the
    calibration model's layout) instead of the seed's draw, without the
    cache.  The measurement runs on ``device``: the card unless the caller
    asks for the CPU; ``"cuda"`` raises on a host without one.
    """
    from repro_torch.core.device import resolve_device
    dev = resolve_device(device)
    if params is not None:
        return _measure(model, seed, percentile, per_channel, params=params,
                        device=dev)
    key = calibration_key(model, seed=seed, percentile=percentile,
                          per_channel=per_channel)
    cdir = pathlib.Path(cache_dir) if cache_dir else calibration_cache_dir()
    path = cdir / f"calib_{key}.npz"
    meta = dict(model=model, seed=seed, percentile=percentile,
                per_channel=per_channel)
    if path.exists() and not refresh:
        try:
            with np.load(path, allow_pickle=False) as z:
                tab = CalibrationTable(
                    table=z["table"], per_tensor_table=z["per_tensor_table"],
                    act_noise=z["act_noise"], absmax=z["absmax"],
                    scale_pctl=z["scale_pctl"], std=z["std"], **meta)
            _CACHE_STATS["hits"] += 1
            return tab
        except (OSError, ValueError, KeyError, EOFError,
                zipfile.BadZipFile) as exc:
            warnings.warn(f"unreadable calibration cache {path}: {exc}; "
                          f"re-measuring", RuntimeWarning, stacklevel=2)
    _CACHE_STATS["misses"] += 1
    tab = _measure(model, seed, percentile, per_channel, device=dev)
    try:
        cdir.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".tmp.npz")
        np.savez(tmp, **tab.state())
        os.replace(tmp, path)
    except OSError as exc:            # read-only FS: the table still serves
        warnings.warn(f"cannot write calibration cache {path}: {exc}",
                      RuntimeWarning, stacklevel=2)
    return tab
