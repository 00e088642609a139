"""The port's PPA models and RTL generator against the JAX package's.

The features, the folds and the polynomial expansion equal the
reference's bit for bit; the ridge fits run in torch float64 (one batched
solve per degree over the folds x lambdas) and agree with the
reference's numpy solves to float64 solve rounding.  On the paper's
720-point space (180 configs per PE type, degree <= 3, <= 84 columns)
the port selects the same (degree, lambda) for all 12 models, and its
``cv_rmse``, ``r2``, ``mape`` and predictions were measured within 1e-13
relative of the reference's (bound below: 1e-9).  The generated Verilog
is the reference's byte for byte.
"""

import numpy as np
import pytest
import torch

from repro.core import accelerator as RA
from repro.core import ppa_model as RM
from repro.core import rtl as RR
from repro.core.pe import PEType as RPE
from repro.core.synthesis import synthesize as r_synthesize
from repro_torch.core import accelerator as TA
from repro_torch.core import ppa_model as TM
from repro_torch.core import rtl as TR
from repro_torch.core.pe import PEType as TPE
from repro_torch.core.synthesis import synthesize as t_synthesize

PPA_RTOL = 1e-9          # float64 solve rounding, torch vs numpy LAPACK
PREDICT_RTOL = 1e-12     # one model, two call shapes


def _by_type(mod, pe):
    return {t: [c for c in mod.design_space() if c.pe_type == t]
            for t in pe}


@pytest.fixture(scope="module")
def suites():
    ref = RM.fit_ppa_suite(_by_type(RA, RPE))
    got = TM.fit_ppa_suite(_by_type(TA, TPE), device="cpu")
    return ref, got


def _rel(a, b) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


def test_feature_matrix_bit_identical():
    ref = RM.feature_matrix(list(RA.design_space()))
    got = TM.feature_matrix(list(TA.design_space()))
    assert got.dtype == ref.dtype and np.array_equal(got, ref)
    assert TM.FEATURE_ORDER == RM.FEATURE_ORDER
    assert TM.TARGETS == RM.TARGETS


@pytest.mark.parametrize("degree", [1, 2, 3])
def test_poly_expand_bit_identical(degree):
    x = np.random.default_rng(degree).standard_normal((37, 6))
    ref = RM.poly_expand(x, degree)
    got = TM.poly_expand(torch.from_numpy(x), degree)
    assert got.dtype == torch.float64
    assert np.array_equal(got.numpy(), ref)
    # a numpy array is taken as a CPU tensor
    assert np.array_equal(TM.poly_expand(x, degree).numpy(), ref)


@pytest.mark.parametrize("n,k,seed", [(23, 5, 0), (180, 5, 0), (50, 3, 7)])
def test_kfold_indices_bit_identical(n, k, seed):
    ref = list(RM.kfold_indices(n, k, seed))
    got = list(TM.kfold_indices(n, k, seed))
    assert len(ref) == len(got) == k
    for (rt, rv), (gt, gv) in zip(ref, got):
        assert np.array_equal(rt, gt) and np.array_equal(rv, gv)


def test_config_features_and_properties_equal():
    for rc, tc in zip(RA.design_space(), TA.design_space()):
        assert tc.features() == rc.features()
        assert (tc.num_pes, tc.glb_bits) == (rc.num_pes, rc.glb_bits)
        assert tc.effective_clock_ghz == rc.effective_clock_ghz
        assert tc.peak_macs_per_s == rc.peak_macs_per_s
    capped = dict(pe_type="int16", clock_ghz=0.5)
    assert (TA.AcceleratorConfig(**capped).effective_clock_ghz
            == RA.AcceleratorConfig(**capped).effective_clock_ghz)


def test_suite_selects_the_reference_models(suites):
    (_, rstats), (_, tstats) = suites
    assert list(tstats) == list(rstats)
    assert len(tstats) == 12
    for key, r in rstats.items():
        t = tstats[key]
        assert (t["degree"], t["lam"], t["n"]) == (
            r["degree"], r["lam"], r["n"]), key
        for m in ("cv_rmse", "r2", "mape"):
            assert _rel(t[m], r[m]) <= PPA_RTOL, (key, m, t[m], r[m])


def test_suite_meets_the_reference_bars(suites):
    """The bars of the reference's Fig. 2 test, on the port's fit."""
    _, (_, tstats) = suites
    for key, s in tstats.items():
        assert s["r2"] > 0.97, (key, s)
        assert s["mape"] < 0.10, (key, s)


def test_suite_predictions_match_reference(suites):
    (rsuite, _), (tsuite, _) = suites
    ref = rsuite.predict_batch(list(RA.design_space()))
    got = tsuite.predict_batch(list(TA.design_space()))
    for t in RM.TARGETS:
        assert got[t].dtype == np.float64
        assert _rel(got[t], ref[t]) <= PPA_RTOL, t


def test_predict_and_predict_batch_agree(suites):
    _, (tsuite, _) = suites
    mixed = [TA.AcceleratorConfig(pe_type=t, pe_rows=r, pe_cols=r)
             for r in (8, 16) for t in TPE]
    batch = tsuite.predict_batch(mixed)
    for i, cfg in enumerate(mixed):
        single = tsuite.predict(cfg)
        for t in TM.TARGETS:
            assert batch[t][i] == pytest.approx(single[t],
                                                rel=PREDICT_RTOL), (i, t)


def test_predict_unseen_config_near_the_oracle(suites):
    _, (tsuite, _) = suites
    cfg = TA.AcceleratorConfig(pe_type=TPE.LIGHTPE1, pe_rows=12, pe_cols=16,
                               glb_kb=192, dram_bw_gbps=10.0)
    pred = tsuite.predict(cfg, device="cpu")
    true = t_synthesize(cfg).as_dict()
    for t in TM.TARGETS:
        assert abs(pred[t] - true[t]) / true[t] < 0.25, t


@pytest.mark.parametrize("log_target", [True, False])
def test_fit_poly_model_matches_reference(log_target):
    """A small fit off the paper space: same selection and predictions
    within solve rounding.  The target is an exact degree-2 polynomial, so
    without the log its CV error (~1e-5 against targets of ~100) is
    itself solve rounding: it is held to 1e-9 of the target's scale."""
    grid = [dict(pe_rows=r, pe_cols=c, glb_kb=g)
            for r in (8, 12, 16, 24) for c in (8, 14, 16) for g in (64, 256)]
    rc = [RA.AcceleratorConfig(**k) for k in grid]
    tc = [TA.AcceleratorConfig(**k) for k in grid]
    y = np.array([c.num_pes ** 2 * 1e-4 + c.glb_kb for c in rc])
    rm = RM.fit_poly_model(rc, y, log_target=log_target)
    tm = TM.fit_poly_model(tc, y, log_target=log_target, device="cpu")
    assert (tm.degree, tm.lam) == (rm.degree, rm.lam)
    assert np.array_equal(tm.mean, rm.mean)
    assert np.array_equal(tm.std, rm.std)
    scale = np.max(np.abs(np.log(y) if log_target else y))
    assert abs(tm.cv_rmse - rm.cv_rmse) <= PPA_RTOL * scale
    assert _rel(tm.predict(tc), rm.predict(rc)) <= PPA_RTOL
    assert np.corrcoef(tm.predict(tc), y)[0, 1] > 0.999


def test_fit_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TM.fit_poly_model([TA.AcceleratorConfig()] * 6, np.ones(6))


def test_synthesize_report_bit_identical():
    for rc, tc in zip(RA.design_space(), TA.design_space()):
        assert t_synthesize(tc).as_dict() == r_synthesize(rc).as_dict()


# ---------------------------------------------------------------------------
# RTL
# ---------------------------------------------------------------------------

RTL_CONFIGS = [
    dict(),
    dict(ifmap_spad=16, filter_spad=128, psum_spad=32),
    dict(pe_rows=8, pe_cols=10),
    dict(pe_rows=8, pe_cols=8),
    dict(pe_rows=16, pe_cols=16),
    dict(pe_rows=32, pe_cols=32, glb_kb=512, dram_bw_gbps=25.6),
    dict(glb_kb=4, ifmap_spad=4, filter_spad=16, psum_spad=8,
         clock_ghz=0.5),
]


@pytest.mark.parametrize("kw", range(len(RTL_CONFIGS)))
@pytest.mark.parametrize("pe_type", [t.value for t in RPE])
def test_generate_rtl_byte_identical(pe_type, kw):
    cfg = dict(RTL_CONFIGS[kw], pe_type=pe_type)
    ref = RR.generate_rtl(RA.AcceleratorConfig(**cfg))
    got = TR.generate_rtl(TA.AcceleratorConfig(**cfg))
    assert got.encode() == ref.encode()
    assert TR.rtl_stats(got) == RR.rtl_stats(ref)


def test_rtl_over_the_paper_space_byte_identical():
    for rc, tc in zip(RA.design_space(), TA.design_space()):
        assert TR.generate_rtl(tc) == RR.generate_rtl(rc)


def test_rtl_stats_structure():
    for t in TPE:
        st = TR.rtl_stats(TR.generate_rtl(TA.AcceleratorConfig(pe_type=t)))
        assert st["endmodules"] == 6
        assert st["has_shift"] == (t in (TPE.LIGHTPE1, TPE.LIGHTPE2))
        assert st["has_multiplier"] == (t == TPE.INT16)
