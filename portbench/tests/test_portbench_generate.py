"""The seeded traffic: the same seed gives the same schedule and pairs,
another seed the same gaps in another order."""

import pytest

from portbench import generate

BIG = 2**31 + 12345


@pytest.mark.parametrize("seed", [0, 7, BIG, 2**40 + 3])
def test_arrivals_are_deterministic(seed):
    a = generate.arrivals(seed, 100.0, 10.0)
    assert a == generate.arrivals(seed, 100.0, 10.0)
    assert len(a) == 1000
    assert a[0] == 0.0
    assert all(x < y for x, y in zip(a, a[1:]))
    assert a[-1] < 10.0


def test_seeds_deal_the_same_gaps_in_another_order():
    a = generate.arrivals(1, 100.0, 10.0)
    b = generate.arrivals(2, 100.0, 10.0)
    assert a != b

    def gaps(t):
        # the gaps between arrivals and the one after the last
        return sorted([y - x for x, y in zip(t, t[1:])] + [10.0 - t[-1]])

    assert gaps(a) == pytest.approx(gaps(b), abs=1e-9)
    assert sum(gaps(a)) == pytest.approx(10.0)


@pytest.mark.parametrize("seed", [3, BIG])
def test_pairs_are_distinct_in_range_and_seeded(seed):
    p = generate.Pairs(seed, 0.05, 0.2).take(2000)
    assert p == generate.Pairs(seed, 0.05, 0.2).take(2000)
    assert len(set(p)) == len(p)
    assert all(0.05 <= c <= 0.2 for pair in p for c in pair)
    assert all(cx + cy <= 0.5 for cx, cy in p)    # the explicit limit
    assert p != generate.Pairs(seed + 1, 0.05, 0.2).take(2000)


def test_sample_and_reservoir_are_seeded():
    assert generate.sample(5, 1000, 16) == generate.sample(5, 1000, 16)
    assert len(set(generate.sample(5, 1000, 16))) == 16
    assert generate.sample(5, 3, 16) == [0, 1, 2]
    r1, r2 = generate.Reservoir(9, 3), generate.Reservoir(9, 3)
    for r in (r1, r2):
        for i in range(100):
            j = r.index()
            if j is not None:
                r.items[j] = i
    assert r1.items == r2.items and len(r1.items) == 3
    assert None not in r1.items and r1.items != [0, 1, 2]
