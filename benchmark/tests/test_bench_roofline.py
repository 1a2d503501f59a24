"""The frozen counts and peaks of ``benchmark/roofline.py`` at the shapes of
PERF.md's kernel table."""

import pytest

from benchmark import roofline


def test_k1_at_the_bench_kus():
    w = roofline.k1(512, 8192, 32, 3)
    assert w.ex2 == 512 * 8192 * 32 == 134_217_728
    assert w.ops == 512 * 8192 * (32 * (3 + 3) + 3)
    assert w.bytes == 4 * (2 * 32 * (512 + 8192) + 32 + 4 + 512 * 8192)
    assert w.limiter() == "ex2"
    assert w.bound_s() == pytest.approx(134_217_728 / roofline.PEAK_EX2)
    assert w.bound_s() * 1e3 == pytest.approx(0.0321, abs=5e-5)


def test_k2_at_the_bench_kuf_is_fp32_bound():
    w = roofline.k2(512, 8192, 32, 3)
    per_element = 32 * (9 + 2 * 3) + 3 * 4 // 2 + 3 + 4
    assert w.ops == 512 * 8192 * per_element
    assert w.ex2 == 512 * 8192 * 32
    assert w.limiter() == "FP32"


def test_lanes_and_extras_scale_the_work():
    one, four = roofline.k1(500, 6553, 8, 8), roofline.k1(500, 6553, 8, 8, lanes=4)
    assert (four.ops, four.ex2, four.bytes) == (4 * one.ops, 4 * one.ex2, 4 * one.bytes)
    assert four.limiter() == "FP32"
    assert roofline.k1(200, 1639, 5, 4, E=8).bytes > roofline.k1(200, 1639, 5, 4).bytes


def test_depth_is_clamped_to_the_grams():
    assert roofline.clamped_depth(8, 3) == 3
    assert roofline.k1(10, 10, 3, 8).ops == roofline.k1(10, 10, 3, 3).ops


def test_peaks_are_the_data_sheet_s():
    assert roofline.PEAK_FP32_FLOPS == 67e12
    assert roofline.PEAK_HBM_BYTES == 3.35e12
    assert roofline.PEAK_EX2 == pytest.approx(4.18e12, rel=1e-3)


def test_step_flops():
    f = roofline.svgp_step_flops(8192, 512, 32, 3)
    assert 10e9 < f < 20e9
    assert roofline.mfu_percent(f, f / roofline.PEAK_FP32_FLOPS) == pytest.approx(100.0)
    assert roofline.sgpr_flops(6553, 500, 8, 8, False) < roofline.sgpr_flops(6553, 500, 8, 8, True)
