"""bench/traffic.py: the same seed gives the same requests; every seed
serves the same sizes in another order."""
from collections import Counter
from itertools import islice

import pytest

from bench.traffic import Traffic, quantile_lengths

MIX = {"prompt_tokens": {"dist": "log_uniform", "min": 1024, "max": 4000},
       "output_tokens": {"dist": "uniform", "min": 8, "max": 64},
       "block": 16, "first_batch": "residual", "engine": {"max_batch": 64}}
SEEDS = [0, 7, 2**31 + 5, 2**33 + 1]


def _sizes(t, n):
    return [t.sizes(i) for i in range(n)]


def test_same_seed_same_requests():
    a = list(islice(Traffic(MIX, 2**31 + 5, 49155).stream(), 20))
    b = list(islice(Traffic(MIX, 2**31 + 5, 49155).stream(), 20))
    assert a == b
    assert all(0 <= x < 49155 for r in a for x in r.prompt)
    c = list(islice(Traffic(MIX, 2**31 + 6, 49155).stream(), 20))
    assert [r.prompt for r in a] != [r.prompt for r in c]


@pytest.mark.parametrize("seed", SEEDS)
def test_each_block_holds_the_same_sizes(seed):
    t = Traffic(MIX, seed, 100)
    ref = Traffic(MIX, 1, 100)
    for b in range(4, 8):      # blocks past the first batch
        block = range(16 * b, 16 * b + 16)
        assert Counter(t.sizes(i)[0] for i in block) == Counter(
            ref.sizes(i)[0] for i in block)
        assert Counter(t.sizes(i)[1] for i in block) == Counter(
            ref.sizes(i)[1] for i in block)
    assert _sizes(t, 128) != _sizes(ref, 128)


def test_first_batch_serves_a_residual_share():
    t = Traffic(MIX, 3, 100)
    drawn = Traffic(dict(MIX, first_batch=None), 3, 100)
    for i in range(64):
        (p, o), (p0, o0) = t.sizes(i), drawn.sizes(i)
        assert p == p0 and 1 <= o <= o0
    assert t.sizes(64) == drawn.sizes(64)
    assert sum(t.sizes(i)[1] for i in range(64)) < sum(
        drawn.sizes(i)[1] for i in range(64)) * 0.6


def test_quantile_lengths_cover_the_range():
    lu = quantile_lengths({"dist": "log_uniform", "min": 512, "max": 2048},
                          16)
    assert lu == sorted(lu) and 512 <= lu[0] < 600 and 1800 < lu[-1] <= 2048
    u = quantile_lengths({"dist": "uniform", "min": 128, "max": 1024}, 16)
    assert 128 <= u[0] < 200 and 950 < u[-1] <= 1024
    with pytest.raises(ValueError):
        quantile_lengths({"dist": "zipf", "min": 1, "max": 2}, 4)



def test_only_a_backlog():
    with pytest.raises(ValueError):
        Traffic(dict(MIX, arrivals="poisson"), 1, 100)
