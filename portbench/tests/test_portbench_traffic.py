"""The traffic generator: the same seed gives the same requests, every
seed the same lengths a cycle, and the mixes' length distributions."""

import json
import math
import statistics

import torch

from conftest import ROOT
from portbench.harness import traffic

BIG_SEEDS = (0, 2 ** 31 + 17, 2 ** 40 + 3, 2 ** 63 - 1)


def mix(name):
    return json.loads((ROOT / "portbench" / "traffic" /
                       f"{name}.json").read_text())


def test_same_seed_same_requests_and_tokens():
    t = mix("prefill-mixed")
    for seed in BIG_SEEDS:
        assert traffic.Schedule(t, seed).take(200) == \
            traffic.Schedule(t, seed).take(200)
        assert torch.equal(traffic.token_pool(seed, 1000, "cpu"),
                           traffic.token_pool(seed, 1000, "cpu"))
    assert traffic.Schedule(t, 1).take(64) != traffic.Schedule(t, 2).take(64)


def test_every_seed_serves_each_cycle_whole():
    t = mix("prefill-mixed")
    base = traffic.cycle_lengths(t)
    for seed in BIG_SEEDS:
        got = [s for s, _ in traffic.Schedule(t, seed).take(3 * len(base))]
        for c in range(3):
            assert sorted(got[c * len(base):(c + 1) * len(base)]) == base


def test_offsets_stay_inside_the_pool():
    for name in ("prefill-mixed", "prefill-long"):
        for s, off in traffic.Schedule(mix(name), 5).take(500):
            assert 0 <= off and off + s <= traffic.POOL_TOKENS


def test_pool_ids_cover_the_vocabulary():
    pool = traffic.token_pool(3, 200064, "cpu")
    assert pool.shape == (traffic.POOL_TOKENS,)
    assert int(pool.min()) >= 0 and int(pool.max()) < 200064
    assert int(pool.max()) > 199000


def test_mixed_lengths_lognormal_quantiles():
    t = mix("prefill-mixed")
    base = traffic.cycle_lengths(t)
    assert len(base) == 64
    assert base == sorted(base)
    assert 128 <= min(base) and max(base) == 4096
    assert abs(statistics.median(base) - 1024) <= 20
    # quantiles of sigma 0.7: log spread of the middle half 2 x 0.674 x 0.7
    q1, q3 = base[16], base[47]
    assert abs(math.log(q3 / q1) - 2 * 0.6745 * 0.7) < 0.05
    assert 1200 < sum(base) / len(base) < 1350


def test_long_mix_is_its_five_lengths():
    assert traffic.cycle_lengths(mix("prefill-long")) == \
        [16384, 20480, 24576, 28672, 32768]
