"""The roofline counters against shapes worked out by hand."""

import pytest

from portbench.harness.spec import ModelShape
from portbench.roofline import (flash_tc, forward, peaks, qmatmul, w4a8_tc,
                                w8a8_tc)

PHI4 = ModelShape("phi4", 32, 3072, 24, 8, 128, 8192, 200064, "swiglu",
                  "w4a8_pow2", 1e4, 1e-6)
SC2 = ModelShape("sc2", 32, 4608, 36, 4, 128, 18432, 49152, "gelu", "w8a8",
                 1e6, 1e-6)


def test_one_w4a8_projection():
    # phi4's gate projection at a 4096-token prompt
    m, k, n = 4096, 3072, 8192
    ops = 2 * 4096 * 3072 * 8192                       # 206,158,430,208
    nbytes = (4096 * 3072 + 3072 * 8192 // 2 + 4 * 8192 + 4
              + 4 * 4096 * 8192)                       # 159,432,708
    assert qmatmul.ops(m, k, n) == ops
    assert qmatmul.nbytes(m, k, n, w4a8_tc.WEIGHT_BYTES) == nbytes
    assert w4a8_tc.least_s(m, k, n) == pytest.approx(ops / 1979e12)
    # one token: the 12.6 MB of codes bound it
    assert w4a8_tc.least_s(1, k, n) == pytest.approx(
        (3072 + 3072 * 4096 + 4 * 8192 + 4 + 4 * 8192) / 3.35e12)


def test_one_w8a8_projection():
    # starcoder2's down projection at 1024 tokens
    m, k, n = 1024, 18432, 4608
    ops = 2 * 1024 * 18432 * 4608
    nbytes = 1024 * 18432 + 18432 * 4608 + 4 * 4608 + 4 + 4 * 1024 * 4608
    assert qmatmul.nbytes(m, k, n, w8a8_tc.WEIGHT_BYTES) == nbytes
    assert w8a8_tc.least_s(m, k, n) == pytest.approx(
        max(ops / 1979e12, nbytes / 3.35e12))
    assert w8a8_tc.least_s(m, k, n) == pytest.approx(ops / 1979e12)


def test_one_causal_flash_call():
    s, h, kvh, hd = 4096, 24, 8, 128
    flops = 4 * 24 * 128 * (4096 * 4097 // 2)        # 103,103,447,040
    assert flash_tc.flops(s, h, hd) == flops
    assert flash_tc.nbytes(s, h, kvh, hd) == 2 * 4096 * 128 * (48 + 16)
    assert flash_tc.least_s(s, h, kvh, hd) == pytest.approx(flops / 989e12)
    # PERF.md's bound of this call: 0.1043 ms
    assert flash_tc.least_s(s, h, kvh, hd) == pytest.approx(1.0425e-4,
                                                             rel=1e-3)


def test_a_forward_has_every_projection_once():
    calls = forward.projections(PHI4, 100)
    assert len(calls) == 32 * 7
    assert calls[:7] == [(100, 3072, 3072), (100, 3072, 1024),
                         (100, 3072, 1024), (100, 3072, 3072),
                         (100, 3072, 8192), (100, 3072, 8192),
                         (100, 8192, 3072)]
    assert len(forward.projections(SC2, 100)) == 32 * 6
    assert forward.attentions(SC2, 7) == [(7, 36, 4, 128)] * 32
    assert forward.logits_flops(PHI4) == 2 * 3072 * 200064


def test_peaks_are_the_data_sheet():
    assert (peaks.INT8_OPS, peaks.BF16_FLOPS, peaks.HBM_BYTES) == \
        (1979e12, 989e12, 3.35e12)
