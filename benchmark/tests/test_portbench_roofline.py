"""The frozen roofline arithmetic gives back rows of PERF.md's kernel
table (its Bound column, on an H100 of 132 SMs at 1980 MHz) from their
shapes alone."""

import pytest

import portbench_toy  # noqa: F401  (the checkout root on sys.path)
from benchmark import roofline

RATES = roofline.card_rates(132, 1980)


def test_card_rates_are_the_tables():
    assert RATES[0] / 1e12 == pytest.approx(33.45, abs=0.01)
    assert RATES[1] / 1e12 == pytest.approx(66.91, abs=0.01)


def test_trial_n32_31_slots():
    # Kernel table: "n = 32 ... 0.004251 (operations, f64 tensor cores)".
    s, by, route = roofline.trial_least_s(32, 31, 35, RATES)
    assert round(s * 1e3, 6) == 0.004251
    assert (by, route) == ("operations", "f64 tensor cores")


def test_trial_n4_31_slots():
    # "n = 4 ... 0.000019 (operations, f32 operations)".
    s, by, route = roofline.trial_least_s(4, 31, 35, RATES)
    assert round(s * 1e3, 6) == 0.000019
    assert (by, route) == ("operations", "f32 operations")


@pytest.mark.parametrize("m,n,want,by", [
    (32, 31, 0.000091, "bytes"),          # "M = 32 ... 0.000091 (bytes)"
    (32, 124, 0.000304, "operations"),    # "M = 32, N = 124 ... (operations)"
    (256, 124, 0.002429, "operations"),   # "M = 256, N = 124 ..."
])
def test_merger_rows(m, n, want, by):
    s, got_by = roofline.merger_int_least_s(n, 80, 16, m, RATES)
    assert round(s * 1e3, 6) == want
    assert got_by == by
