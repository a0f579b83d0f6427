import pytest

from rlbench.stats import percentile, rate, spread


def test_tail_and_rate_count_a_stall():
    lat = [0.1] * 95 + [0.1] * 4 + [3.0]          # one stall in 100
    p95 = percentile(lat, 95)
    assert p95 == pytest.approx(0.1)
    lat = [0.1] * 90 + [2.0] * 10                  # ten stalls in 100
    assert percentile(lat, 95) == pytest.approx(2.0)
    # the whole window's rate: all the work over all the time, stall in
    assert rate(29 * len(lat), sum(lat)) == pytest.approx(
        29 * 100 / (9 + 20))
    assert percentile([0.25], 95) == 0.25


def test_spread_is_the_quartile_distance_over_the_median():
    assert spread([1.0, 1.0, 1.0, 1.0, 1.0, 1.0]) == 0.0
    s = spread([0.9, 1.0, 1.0, 1.0, 1.0, 1.1])
    assert 0.0 < s < 0.2
    with pytest.raises(ValueError):
        rate(10, 0.0)
