"""The port's host-side copies against the JAX package's modules.

Enumeration, config hashing, synthesis, the synthesis cache, the PE
execution modes, the traffic traces and the search presets stay host code
in the port, copied rather than imported; these tests pin each copy
bit-identical to the reference on the same inputs, and load a cache file
written by the reference into the port's cache.
"""

import numpy as np
import pytest

from repro.core import accelerator as RA
from repro.core import confighash as RH
from repro.core import dataflow as RF
from repro.core import pe as RP
from repro.core import synthesis as RS
from repro.core import workloads as RW
from repro.core.dse_batch import _make_cfg_lay as r_make_cfg_lay
from repro.core.dse_batch import _workload_batch as r_workload_batch
from repro_torch.core import accelerator as TA
from repro_torch.core import confighash as TH
from repro_torch.core import dataflow as TF
from repro_torch.core import pe as TP
from repro_torch.core import synthesis as TS
from repro_torch.core import workloads as TW
from repro_torch.core.dse_batch import _make_cfg_lay as t_make_cfg_lay
from repro_torch.core.dse_batch import _workload_batch as t_workload_batch

GRIDS = [
    {},                                             # the paper's 720 points
    dict(glb_kbs=(64, 128, 256, 512),
         bws=tuple(np.linspace(2.0, 64.0, 64))),    # the quick chunked grid
    dict(glb_kbs=(4, 4096), bws=(2.0, 63.9), pe_types=("fp32", "lightpe1")),
]


def _assert_dicts_equal(a: dict, b: dict):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("grid", range(len(GRIDS)))
def test_design_space_soa_bit_identical(grid):
    kw = GRIDS[grid]
    ref = list(RA.design_space_soa(chunk_size=1000, **kw))
    got = list(TA.design_space_soa(chunk_size=1000, **kw))
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        _assert_dicts_equal(r, g)


def test_design_space_and_configs_round_trip():
    ref = list(RA.design_space())
    got = list(TA.design_space())
    assert [c.name() for c in ref] == [c.name() for c in got]
    soa = TA.configs_to_soa(got)
    _assert_dicts_equal(RA.configs_to_soa(ref), soa)
    back = TA.soa_to_configs(soa, [0, 5, 719])
    assert [c.name() for c in back] == [got[i].name() for i in (0, 5, 719)]


def test_pe_constants_and_energy_helpers():
    for t in RP.PEType:
        assert RP.pe_spec(t).__dict__ == {
            **TP.pe_spec(t.value).__dict__, "pe_type": t}
        assert RP._P_PE_LEAK_UW[t] == TP._P_PE_LEAK_UW[TP.PEType(t.value)]
    bits = np.array([0, 1, 255, 8192, 123456, 33554432], dtype=np.int64)
    assert np.array_equal(RP.rf_access_energy_pj(bits),
                          TP.rf_access_energy_pj(bits))
    assert np.array_equal(RP.sram_access_energy_pj(bits),
                          TP.sram_access_energy_pj(bits))
    assert np.array_equal(RP.sram_area_um2(bits.astype(float)),
                          TP.sram_area_um2(bits.astype(float)))


def test_pe_execution_modes():
    for h in RP.PEType:
        assert [m.value for m in TP.supported_modes(h.value)] \
            == [m.value for m in RP.supported_modes(h)]
        for m in RP.PEType:
            assert TP.supports_mode(h.value, m.value) \
                == RP.supports_mode(h, m)
    got, want = TP.mode_compat_matrix(), RP.mode_compat_matrix()
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_workload_batch_many_identical():
    from repro.core.dse_batch import _workload_batch_many as r_many
    from repro_torch.core.dse_batch import _workload_batch_many as t_many
    names = ("vgg16", "resnet34", "resnet50")
    rb, rbounds = r_many(tuple(RW.get_workload(n) for n in names))
    tb, tbounds = t_many(tuple(TW.get_workload(n) for n in names))
    assert tbounds == rbounds == ((0, 16), (16, 53), (53, 107))
    assert (tb.name, tb.layer_names) == (rb.name, rb.layer_names)
    _assert_dicts_equal(rb.arrays, tb.arrays)


def test_traffic_copy_bit_identical():
    from repro.serving import traffic as RT
    from repro_torch.serving import traffic as TT
    assert list(TT.TRAFFIC_PRESETS) == list(RT.TRAFFIC_PRESETS)
    for name in RT.TRAFFIC_PRESETS:
        assert TT.get_traffic(name).__dict__ == RT.get_traffic(name).__dict__
        for seed in (None, 3):
            r = RT.make_trace(name, seed=seed)
            t = TT.resolve_traffic(TT.get_traffic(name)) if seed is None \
                else TT.make_trace(name, seed=seed)
            assert t.name == r.name and t.slo_s == r.slo_s
            for f in ("arrival_s", "prompt_tokens", "decode_tokens"):
                assert np.array_equal(getattr(t, f), getattr(r, f)), f
            assert t.total_tokens == r.total_tokens
    with pytest.raises(ValueError, match="unknown traffic preset"):
        TT.get_traffic("flood")


def test_presets_equal_reference():
    from repro.configs import coexplore_presets as RC
    from repro_torch.configs import coexplore_presets as TC
    assert list(TC.PRESETS) == list(RC.PRESETS)
    for name, r in RC.PRESETS.items():
        t = TC.get_preset(name)
        for f in ("method", "budget", "pop_size", "mutation_rate",
                  "objectives", "seed", "chunk_size", "eta", "weights",
                  "traffic", "n_slots", "archive_epsilon"):
            assert getattr(t, f) == getattr(r, f), (name, f)
        assert (t.accuracy is None) == (r.accuracy is None)
        if r.accuracy is not None:
            assert t.accuracy.__dict__ == r.accuracy.__dict__
    with pytest.raises(ValueError, match="unknown co-exploration preset"):
        TC.get_preset("fastest")
    with pytest.raises(ValueError, match="archive_epsilon"):
        TC.CoExplorePreset(name="x", method="random", archive_epsilon=0.1)
    with pytest.raises(ValueError, match="need traffic"):
        TC.CoExplorePreset(name="x", objectives=("p99_latency_s",))


def test_workloads_identical():
    for name in RW.WORKLOADS:
        r, t = RW.get_workload(name), TW.get_workload(name)
        assert r.name == t.name
        assert [l.__dict__ for l in r.layers] == [l.__dict__ for l in t.layers]
        assert [l.macs for l in r.layers] == [l.macs for l in t.layers]
        _assert_dicts_equal(r_workload_batch(r).arrays,
                            t_workload_batch(t).arrays)


@pytest.mark.parametrize("grid", range(len(GRIDS)))
def test_digests_and_synthesis_bit_identical(grid):
    soa = next(iter(RA.design_space_soa(**GRIDS[grid])))
    ref_d = RH.config_digests(soa)
    got_d = TH.config_digests(soa)
    for a, b in zip(ref_d, got_d):
        assert np.array_equal(a, b)
    assert RH.digest_keys(ref_d) == TH.digest_keys(got_d)
    _assert_dicts_equal(RS.synthesize_soa(soa), TS.synthesize_soa(soa))
    assert np.array_equal(RF.leakage_mw_soa(soa), TF.leakage_mw_soa(soa))


def test_make_cfg_lay_identical():
    soa = next(iter(RA.design_space_soa()))
    cols = RS.synthesize_soa(soa)
    rc, rl = r_make_cfg_lay(soa, cols, r_workload_batch(RW.vgg16()))
    tc, tl = t_make_cfg_lay(soa, cols, t_workload_batch(TW.vgg16()))
    _assert_dicts_equal(rc, tc)
    _assert_dicts_equal(rl, tl)


def test_reference_npz_cache_loads_with_zero_misses(tmp_path):
    path = tmp_path / "synth.npz"
    soa = next(iter(RA.design_space_soa(**GRIDS[1])))
    ref_cache = RS.PersistentSynthesisCache(path)
    want = ref_cache.synthesize(soa)
    ref_cache.save()
    cache = TS.PersistentSynthesisCache(path)
    assert len(cache) == len(ref_cache)
    got = cache.synthesize(soa)
    assert cache.misses == 0 and cache.hits == len(soa["pe_rows"])
    for k in TS.REPORT_COLUMNS:
        assert np.array_equal(got[k], want[k]), k


def test_port_npz_cache_loads_in_reference(tmp_path):
    path = tmp_path / "synth.npz"
    soa = next(iter(RA.design_space_soa()))
    cache = TS.PersistentSynthesisCache(path)
    cache.synthesize(soa)
    cache.save()
    ref_cache = RS.PersistentSynthesisCache(path)
    ref_cache.synthesize(soa)
    assert ref_cache.misses == 0 and ref_cache.hits == 720


def test_cache_accounting_and_eviction_as_reference():
    soa = next(iter(RA.design_space_soa(**GRIDS[1])))
    caches = (RS.PersistentSynthesisCache(max_rows=1000),
              TS.PersistentSynthesisCache(max_rows=1000))
    for c in caches:
        for s in range(0, len(soa["pe_rows"]), 700):
            c.synthesize({k: v[s:s + 700] for k, v in soa.items()})
        c.synthesize({k: v[:300] for k, v in soa.items()})
    r, t = caches
    assert (r.hits, r.misses, r.evictions, len(r)) \
        == (t.hits, t.misses, t.evictions, len(t))


def test_corrupt_cache_file_warns_and_rebuilds(tmp_path):
    path = tmp_path / "bad.npz"
    path.write_bytes(b"not an npz")
    with pytest.warns(RuntimeWarning, match="unreadable"):
        cache = TS.PersistentSynthesisCache(path)
    assert len(cache) == 0
    with pytest.raises(Exception):
        cache.load(path)


def test_accelerator_properties_and_features_identical():
    cfgs = list(RA.design_space()) + [RA.AcceleratorConfig(clock_ghz=0.4),
                                      RA.AcceleratorConfig(clock_ghz=9.0)]
    for rc in cfgs:
        tc = TA.AcceleratorConfig(**{f: getattr(rc, f) for f in (
            "pe_type", "pe_rows", "pe_cols", "ifmap_spad", "filter_spad",
            "psum_spad", "glb_kb", "dram_bw_gbps", "clock_ghz")})
        for prop in ("num_pes", "effective_clock_ghz", "peak_macs_per_s",
                     "glb_bits"):
            assert getattr(tc, prop) == getattr(rc, prop), prop
        assert tc.features() == rc.features()
        assert tc.spec.__dict__.keys() == rc.spec.__dict__.keys()
        assert tc.pe_type.pretty == rc.pe_type.pretty


def test_synthesis_reports_and_keys_identical():
    rcs, tcs = list(RA.design_space()), list(TA.design_space())
    assert [r.as_dict() for r in TS.synthesize_many(tcs, use_cache=False)] \
        == [r.as_dict() for r in RS.synthesize_many(rcs, use_cache=False)]
    assert TS.config_keys(tcs) == RS.config_keys(rcs)
    capped = dict(pe_type="int16", clock_ghz=0.5)
    assert TS.config_hash(TA.AcceleratorConfig(**capped)) == \
        RS.config_hash(RA.AcceleratorConfig(**capped))
    assert TS.synthesize(tcs[7]).as_dict() == RS.synthesize(rcs[7]).as_dict()


def test_report_cache_accounting_as_reference():
    """The in-process report LRU counts, evicts and serves as the
    reference's."""
    rcs, tcs = list(RA.design_space())[:50], list(TA.design_space())[:50]
    stats = []
    for S, cfgs in ((RS, rcs), (TS, tcs)):
        S.clear_synthesis_cache()
        old = S.set_synthesis_cache_limit(20)
        try:
            S.synthesize_many(cfgs[:30])
            S.synthesize_many(cfgs[20:50])
            S.synthesize_cached(cfgs[49])
            S.synthesize_cached(cfgs[0])
            st = S.synthesis_cache_stats()
        finally:
            S.set_synthesis_cache_limit(old)
            S.clear_synthesis_cache()
        stats.append({k: st[k] for k in ("hits", "misses", "evictions",
                                         "size", "limit")})
    assert stats[0] == stats[1]


def test_cache_export_import_state_as_reference():
    soa = next(iter(TA.design_space_soa(chunk_size=300)))
    r_cache, t_cache = RS.PersistentSynthesisCache(max_rows=256), \
        TS.PersistentSynthesisCache(max_rows=256)
    for c in (r_cache, t_cache):
        c.synthesize(soa)
        c.synthesize({k: v[:40] for k, v in soa.items()})
    r_st, t_st = r_cache.export_state(), t_cache.export_state()
    assert list(t_st) == list(r_st)
    for k in r_st:
        assert np.array_equal(t_st[k], r_st[k]), k
    back = TS.PersistentSynthesisCache()
    back.import_state(r_st)
    assert (back.hits, back.misses, back.evictions, len(back)) == (
        r_cache.hits, r_cache.misses, r_cache.evictions, len(r_cache))
    with pytest.raises(ValueError, match="not \\(N, 2\\)"):
        back.import_state(dict(r_st, vals=r_st["vals"][:, :2]))
    back.clear()
    assert len(back) == 0 and back.hits == 0
