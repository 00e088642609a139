"""Tier-1 calibration of the port (:mod:`repro_torch.quant.calibrate`)
against the reference's (:mod:`repro.quant.calibrate`).

The reference measures on ``m.init(jax.random.key(seed))`` of the
calibration model; the port cannot draw those weights, so each parity
test draws them with the reference in-process and hands them to the port
converted (``models/convert.from_reference_params``).  On the CPU the two
tables are then equal bit for bit: the port's quantize-dequantize equals
the reference's element for element, and the noise ratios, shares and
sums run in float64 numpy in the reference's order.  The cache key and
directory are the port's own, so neither package reads the other's
tables.
"""

import dataclasses
import pathlib
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.configs.base import reduced as r_reduced
from repro.models.model import Model as RModel
from repro.quant import calibrate as RC
from repro_torch.models.convert import from_reference_params
from repro_torch.quant import calibrate as TC
from test_torch_serve import to_numpy_tree

FIELDS = ("table", "per_tensor_table", "act_noise", "absmax",
          "scale_pctl", "std")


def reference_calibration_params(model: str, seed: int = 0):
    """The params the reference's ``_measure(model, seed, ...)`` draws, as
    the port's tensors on the CPU."""
    cfg = r_get_config(model)
    rparams = RModel(r_reduced(cfg, n_layers=cfg.n_layers)).init(
        jax.random.key(seed))
    return from_reference_params(TC.calibration_config(model),
                                 to_numpy_tree(rparams), device="cpu")


@pytest.mark.parametrize("model,per_channel,percentile", [
    ("mamba2-130m", True, 99.9), ("mamba2-130m", False, 50.0),
    ("phi4-mini-3.8b", True, 99.9), ("moonshot-v1-16b-a3b", True, 99.9),
    ("zamba2-1.2b", True, 99.9)])
def test_table_equals_reference_bit_for_bit(model, per_channel, percentile):
    """The SSM, dense, MoE (3-D experts left out) and hybrid (shared block
    left out) layouts: every field of the table equal to the reference's
    ``_measure`` on the same tensors."""
    want = RC._measure(model, 0, percentile, per_channel)
    got = TC._measure(model, 0, percentile, per_channel,
                      params=reference_calibration_params(model),
                      device="cpu")
    assert got.n_layers == want.n_layers == r_get_config(model).n_layers
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == np.float64 and a.shape == b.shape, f
        assert np.array_equal(a, b), f
    assert (got.model, got.seed, got.percentile, got.per_channel) == \
        (want.model, want.seed, want.percentile, want.per_channel)


@pytest.mark.parametrize("model", ["mamba2-130m", "moonshot-v1-16b-a3b",
                                   "zamba2-1.2b", "whisper-medium"])
def test_layer_weights_in_reference_order(model):
    """Each layer's projections in the reference's order (its sorted
    stacked leaves, 3-D ones skipped), on the same tensors."""
    cfg = r_get_config(model)
    rparams = RModel(r_reduced(cfg, n_layers=cfg.n_layers)).init(
        jax.random.key(0))
    want = RC._collect_layer_weights(rparams, cfg.n_layers)
    got = TC._collect_layer_weights(from_reference_params(
        TC.calibration_config(model), to_numpy_tree(rparams), device="cpu"))
    assert [len(ws) for ws in got] == [len(ws) for ws in want]
    for gl, wl in zip(got, want):
        for g, w in zip(gl, wl):
            assert np.array_equal(g.numpy().astype(np.float64), w)


def test_spec_words_are_the_reference_words_and_a_port_word():
    for spec in (("mamba2-130m", 0, 99.9, True), ("gemma3-4b", 7, 50.0,
                                                  False)):
        want = [int(w) for w in RC._spec_words(*spec)]
        got = [int(w) for w in TC._spec_words(*spec)]
        assert got == want + [TC.PORT_WORD]


def test_cache_keys_and_directories_never_coincide(monkeypatch, tmp_path):
    specs = [dict(), dict(seed=1), dict(percentile=50.0),
             dict(per_channel=False)]
    for model in ("mamba2-130m", "phi4-mini-3.8b", "gemma3-4b"):
        for kw in specs:
            assert TC.calibration_key(model, **kw) != \
                RC.calibration_key(model, **kw)
    keys = {TC.calibration_key("mamba2-130m", **kw) for kw in specs}
    assert len(keys) == len(specs)
    monkeypatch.delenv("REPRO_CALIB_CACHE", raising=False)
    monkeypatch.delenv("REPRO_TORCH_CALIB_CACHE", raising=False)
    assert TC.calibration_cache_dir() != RC.calibration_cache_dir()
    assert TC.calibration_cache_dir().parts[-2] == "repro-qappa-torch"
    # each package reads only its own variable
    monkeypatch.setenv("REPRO_CALIB_CACHE", str(tmp_path / "ref"))
    assert TC.calibration_cache_dir() != tmp_path / "ref"
    monkeypatch.setenv("REPRO_TORCH_CALIB_CACHE", str(tmp_path / "port"))
    assert TC.calibration_cache_dir() == tmp_path / "port"
    assert RC.calibration_cache_dir() == tmp_path / "ref"


def test_tables_of_the_two_packages_stay_apart(tmp_path):
    """One shared directory: each package writes and reads only its own
    files (the port's table is measured on its own draw)."""
    RC.calibrate_model("mamba2-130m", cache_dir=str(tmp_path))
    RC.reset_calibration_cache_stats()
    TC.reset_calibration_cache_stats()
    TC.calibrate_model("mamba2-130m", cache_dir=str(tmp_path), device="cpu")
    assert TC.calibration_cache_stats() == {"hits": 0, "misses": 1}
    assert len(list(tmp_path.glob("calib_*.npz"))) == 2
    RC.calibrate_model("mamba2-130m", cache_dir=str(tmp_path))
    assert RC.calibration_cache_stats() == {"hits": 1, "misses": 0}


def test_cache_hit_refresh_and_unreadable_entry(tmp_path):
    TC.reset_calibration_cache_stats()
    a = TC.calibrate_model("mamba2-130m", cache_dir=str(tmp_path),
                           device="cpu")
    b = TC.calibrate_model("mamba2-130m", cache_dir=str(tmp_path),
                           device="cpu")
    assert TC.calibration_cache_stats() == {"hits": 1, "misses": 1}
    assert b.digest() == a.digest()
    for f in FIELDS:
        assert np.array_equal(getattr(a, f), getattr(b, f))
    c = TC.calibrate_model("mamba2-130m", cache_dir=str(tmp_path),
                           refresh=True, device="cpu")
    assert TC.calibration_cache_stats()["misses"] == 2
    assert c.digest() == a.digest()
    path, = tmp_path.glob("calib_*.npz")
    assert path.name == f"calib_{TC.calibration_key('mamba2-130m')}.npz"
    path.write_bytes(b"not an npz")
    with pytest.warns(RuntimeWarning, match="unreadable calibration cache"):
        d = TC.calibrate_model("mamba2-130m", cache_dir=str(tmp_path),
                               device="cpu")
    assert d.digest() == a.digest()
    with np.load(path) as z:            # re-measured and rewritten
        assert np.array_equal(z["table"], a.table)


def test_injected_params_are_measured_uncached(tmp_path):
    params = reference_calibration_params("mamba2-130m")
    TC.reset_calibration_cache_stats()
    tab = TC.calibrate_model("mamba2-130m", cache_dir=str(tmp_path),
                             params=params, device="cpu")
    assert TC.calibration_cache_stats() == {"hits": 0, "misses": 0}
    assert not list(tmp_path.iterdir())
    drawn = TC.calibrate_model("mamba2-130m", cache_dir=str(tmp_path),
                               device="cpu")
    assert drawn.digest() != tab.digest()
    assert np.array_equal(tab.table, RC._measure("mamba2-130m", 0, 99.9,
                                                 True).table)


def test_port_draw_does_not_depend_on_the_device():
    """The port draws on the CPU and then moves the tensors: the same
    draw as ``Model(calib_cfg, device="cpu").init(Generator(seed))``."""
    from repro_torch.models.model import Model
    cfg = TC.calibration_config("mamba2-130m")
    got = TC.calibration_params(cfg, 3, torch.device("cpu"))
    want = Model(cfg, device="cpu").init(torch.Generator("cpu")
                                         .manual_seed(3))
    assert torch.equal(got["embed"], want["embed"])
    assert all(torch.equal(a["in_proj"], b["in_proj"])
               for a, b in zip(got["layers"], want["layers"]))
    assert cfg.n_layers == r_get_config("mamba2-130m").n_layers
    assert cfg.d_model == 64


def test_digest_and_state_round_trip():
    tab = TC._measure("mamba2-130m", 0, 99.9, True,
                      params=reference_calibration_params("mamba2-130m"),
                      device="cpu")
    again = TC.CalibrationTable(model=tab.model, seed=tab.seed,
                                percentile=tab.percentile,
                                per_channel=tab.per_channel,
                                **{k: v.copy() for k, v in tab.state().items()})
    assert again.digest() == tab.digest()
    assert set(tab.state()) == set(FIELDS)
    bumped = dataclasses.replace(tab, table=tab.table * 1.5)
    assert bumped.digest() != tab.digest()
    # the reference's digest of the same content differs by the port word
    ref = RC.CalibrationTable(model=tab.model, seed=tab.seed,
                              percentile=tab.percentile,
                              per_channel=tab.per_channel, **tab.state())
    assert ref.digest() != tab.digest()


def test_calibration_refuses_the_card_without_one(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TC.calibrate_model("mamba2-130m", cache_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TC._measure("mamba2-130m", 0, 99.9, True)


def test_no_analytic_fallback():
    """The reference's proxy fallback (for an unusable jax) has no
    counterpart: an unknown model raises, nothing is broadcast."""
    assert not hasattr(TC, "_analytic_fallback")
    with pytest.raises(KeyError, match="unknown arch"):
        TC._measure("resnet-9000", 0, 99.9, True, device="cpu")
