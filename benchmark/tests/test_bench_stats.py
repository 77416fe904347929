"""The arithmetic of the end-to-end metrics and the roofline counts."""
import statistics

import pytest

from benchmark import roofline, stats


def test_percentile_interpolates_between_ranks():
    values = list(range(1, 101))  # 1..100
    assert stats.percentile(values, 50) == pytest.approx(50.5)
    assert stats.percentile(values, 95) == pytest.approx(95.05)
    assert stats.percentile(list(range(101)), 95) == 95
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile([4.0, 1.0, 3.0, 2.0], 0) == 1.0
    assert stats.percentile([4.0, 1.0, 3.0, 2.0], 100) == 4.0


def test_rate_is_all_work_over_all_time():
    assert stats.rate(131072 * 200, 4.0) == 131072 * 50
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_spread_uses_statistics_quartiles():
    values = [10.0, 10.2, 9.9, 10.1, 10.4, 9.8]
    q1, med, q3 = statistics.quantiles(values, n=4)
    assert stats.spread(values) == pytest.approx(
        (q3 - q1) / statistics.median(values))


@pytest.mark.parametrize("batch, nx, iters, flops, nbytes", [
    (262144, 10, 60, 262144 * (20 + 2000 + 60 * 320), 262144 * 4 * 150),
    (65536, 10, 60, 65536 * (20 + 2000 + 60 * 320), 65536 * 4 * 150),
])
def test_qp_solve_work_at_the_cells_shapes(batch, nx, iters, flops, nbytes):
    assert roofline.qp_solve_work(batch, nx, iters) == (flops, nbytes)


def test_terminal_work_at_the_cells_shape():
    # revise2.sweep-64k: nlift 10, m 1, 30 doubling steps
    per = (2 + 20 + 200) + 30 * (22 * 1000 + 400) + (400 + 40 + 1 + 2 + 10)
    flops, nbytes = roofline.terminal_work(65536, 10, 1, 30)
    assert flops == 65536 * per == 44_084_428_800
    assert nbytes == 4 * (65536 * 221 + 101)


def test_least_time_takes_the_slower_bound():
    flops, nbytes = roofline.qp_solve_work(262144, 10, 60)
    t = roofline.least_seconds(flops, nbytes)
    assert t == pytest.approx(flops / 67e12)  # operations bound it
    assert t > nbytes / 3.35e12
    assert roofline.least_seconds(0, 3.35e12) == pytest.approx(1.0)
