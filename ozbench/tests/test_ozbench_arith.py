"""The yardstick's arithmetic against counts made by hand, and the window's
statistics on synthetic timings."""

import statistics

import pytest

from harness import roofline, stats


def test_pairs_are_the_modes_slice_pairs():
    assert [roofline.pairs(ns) for ns in (3, 9, 18)] == [6, 45, 171]


@pytest.mark.parametrize("mode, ns", [("fp64_int8_9", 9), ("fp64_int8_18", 18),
                                      ("fp64_int8_auto", None), ("fp32_bf16x3", None)])
def test_num_split_of_a_mode(mode, ns):
    assert roofline.num_split(mode) == ns


def test_recombine_at_16384_is_45_pairs_of_2n3_at_the_int8_peak():
    p = roofline.Product(1, 16384, 16384, 16384, 9)
    assert roofline.int8_ops(p) == 45 * 2 * 16384**3
    assert roofline.recombine_least_s(p) == pytest.approx(45 * 2 * 16384**3 / 1979e12)
    assert roofline.recombine_least_s(p) == pytest.approx(0.2000, abs=1e-4)
    assert roofline.engine_least_s(p) == roofline.recombine_least_s(p)


def test_byte_bound_stages_count_one_read_and_one_write():
    p = roofline.Product(4, 4096, 4096, 4096, 9)
    elems = 4096 * 4096
    assert roofline.split_least_s(p) == pytest.approx(
        4 * (2 * elems * (8 + 9) + 4 * 2 * 4096) / 3.35e12)
    assert roofline.epilogue_least_s(p) == pytest.approx(4 * (20 * elems + 4 * 8192) / 3.35e12)
    with_c = p._replace(beta=True)
    assert roofline.epilogue_least_s(with_c) == pytest.approx(
        4 * (28 * elems + 4 * 8192) / 3.35e12)


def test_short_k_recombine_is_bound_by_operations_not_bytes():
    p = roofline.Product(1, 23552, 23552, 1024, 9)
    ops_s = 45 * 2 * 23552**2 * 1024 / 1979e12
    bytes_s = (9 * 2 * 23552 * 1024 + 12 * 23552**2) / 3.35e12
    assert ops_s > bytes_s
    assert roofline.recombine_least_s(p) == pytest.approx(ops_s)


def test_hpl_flops():
    n = 45056
    assert roofline.hpl_flops(n) == pytest.approx(2 / 3 * n**3 + 3 / 2 * n**2)
    assert roofline.hpl_flops(100) == pytest.approx(2 / 3 * 1e6 + 1.5e4)


def test_lu_products_cover_every_step_with_a_trailing_block():
    prods = roofline.lu_products(3000, 1024, 9)
    # steps at j = 0 and 1024 have trailing blocks; the last (952 columns) has none
    assert prods == [
        roofline.Product(1, 1024, 1976, 1024, 9),
        roofline.Product(1, 1976, 1976, 1024, 9, True),
        roofline.Product(1, 1024, 952, 1024, 9),
        roofline.Product(1, 952, 952, 1024, 9, True),
    ]
    # the trailing updates carry the LU's 2/3·n³ less the panels' share
    n, nb = 45056, 1024
    upd = sum(roofline.fp64_flops(p) for p in roofline.lu_products(n, nb, 9))
    assert 0.9 * 2 / 3 * n**3 < upd < 2 / 3 * n**3 + n**2 * nb * 2


def test_rate_is_all_the_work_over_all_the_time():
    # 7 units of 8.8e12 flops in 3.5 s, whatever the units' own times were
    assert stats.rate(7, 8.8e12, 3.5) == pytest.approx(7 * 8.8e12 / 3.5)
    with pytest.raises(ValueError):
        stats.rate(1, 1.0, 0.0)


def test_p95_is_over_every_call():
    lat = [1.0] * 950 + [5.0] * 50
    assert stats.percentile(lat, 95) == 1.0
    assert stats.percentile(lat + [9.0], 95) == 5.0
    assert stats.percentile(list(range(1, 101)), 95) == 95
    assert stats.percentile([3.0], 95) == 3.0
    lat = [0.001 * (1 + (i % 20) / 10) for i in range(10000)]
    assert stats.percentile(lat, 50) == pytest.approx(statistics.median_low(lat))
