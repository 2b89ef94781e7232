"""The percentile, rate, spread and device-union arithmetic."""

import math

import pytest

import devtrace
import stats


def test_percentile_interpolates_like_numpy():
    xs = [10, 20, 30, 40, 50]
    assert stats.percentile(xs, 0) == 10
    assert stats.percentile(xs, 100) == 50
    assert stats.percentile(xs, 50) == 30
    assert stats.percentile(xs, 90) == pytest.approx(46.0)
    assert stats.percentile([5, 1, 3], 50) == 3
    assert stats.percentile([1.0, math.inf], 90) == math.inf


def test_rate_and_spread():
    assert stats.rate(300, 2.0) == 150
    with pytest.raises(ValueError):
        stats.rate(1, 0)
    # statistics.quantiles(n=4) of 1..8: 2.25, 4.5, 6.75
    assert stats.spread(range(1, 9)) == pytest.approx(4.5 / 4.5)


def test_union_and_gaps():
    merged = devtrace.union([(5, 7), (0, 2), (1, 3), (7, 8)])
    assert merged == [(0, 3), (5, 8)]
    assert devtrace.gaps(merged, 0, 10) == [(3, 5), (8, 10)]
    assert devtrace.gaps(merged, -1, 4) == [(-1, 0), (3, 4)]


def test_summarize_clips_to_the_window_and_names_idle_gaps():
    kernels = [("nvjet_gemm", 0, 40), ("flash_fwd_kernel_wgmma", 30, 50),
               ("elementwise", 70, 90), ("outside", 200, 300)]
    host = [("aten::item", 50, 70), ("train.step", 0, 100),
            ("cudaLaunchKernel", 55, 56)]
    s = devtrace.summarize(kernels, host, (0, 100))
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(70e-6)          # [0, 50] + [70, 90]
    assert s["family_s"] == pytest.approx(
        {"gemm": 40e-6, "flash_fwd": 20e-6, "other": 20e-6})
    # the gap [50, 70] falls in aten::item, the tail [90, 100] in the step
    assert dict(s["idle_gaps"]) == pytest.approx(
        {"aten::item": 20e-6, "train.step": 10e-6})
    assert s["top_ops"][0] == ("nvjet_gemm", pytest.approx(40e-6))


def test_family_buckets():
    assert devtrace.family("flash_bwd_dkv_kernel_delta") == "flash_bwd_dkv"
    assert devtrace.family("sm90_xmma_gemm_bf16") == "gemm"
    assert devtrace.family("cub::DeviceRadixSortOnesweepKernel") == "sort"
    assert devtrace.family("indexSelectLargeIndex") == "index"
    assert devtrace.family("vectorized_elementwise_kernel") == "other"
