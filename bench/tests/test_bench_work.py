"""The benchmark's logical-work arithmetic against hand counts, and its
statistics."""

from __future__ import annotations

import math

import pytest

import bench_small as bs
from benchlib import stats, work


def test_b1_at_1024_rows_of_the_qwen_half():
    # 2 * 1024 * 5120 * 1280 * (K + 2) FLOPs at 67 TFLOP/s = 1.0016 ms
    w = work.kan_layer(1024, 5120, 1280, 8, 3, 8, 8, 8, 2, 2)
    assert w.flops["float32"] == 2 * 1024 * 5120 * 1280 * 5
    assert w.bound_s() * 1e3 == pytest.approx(1.0016, abs=5e-5)
    # bytes: int8 c' and w_b, two f32 scales per column, the 32 x 4 LUT,
    # bf16 rows in and out
    assert w.nbytes == (5120 * 11 * 1280 + 5120 * 1280 + 2 * 1280 * 4
                        + 32 * 4 + 1024 * (5120 + 1280) * 2)


def test_kan1_request_by_hand():
    cfg = bs.manifest().config("kan1-knot-g5-8b")
    calls = work.kan_network(65536, cfg)
    assert [c.flops["float32"] for c in calls] == [
        2 * 65536 * 17 * 1 * 5, 2 * 65536 * 1 * 14 * 5]
    # layer 0: 17 x 8 x 1 + 17 x 1 int8, 2 scales, 32 x 4 LUT, f32 rows
    assert calls[0].nbytes == 17 * 8 + 17 + 8 + 128 + 65536 * 18 * 4
    # memory-bound: the bytes at 3.35 TB/s
    assert calls[0].bound_s() == pytest.approx(calls[0].nbytes / 3.35e12)


def test_lm_decode_and_prefill_counts():
    m = work.LMDims.of(bs.manifest().config("qwen2.5-14b-kanffn-4l"))
    assert (m.d, m.heads, m.kv_heads, m.head_dim, m.hidden) == (
        5120, 40, 8, 128, 1280)
    a = work.attn_decode(m, [100, 300])
    assert a.flops["bfloat16"] == 4 * 400 * 40 * 128
    assert a.nbytes == 2 * 400 * 8 * 128 * 2 + 2 * 2 * 40 * 128 * 2
    p = work.lm_prefill(m, 1000)
    assert len(p["b1"]) == 8 and len(p["b2"]) == 4 and len(p["head"]) == 1
    per_token = 2 * 5120 * (5120 + 2048) + 2 * 5120 * 5120
    assert work.total(p["proj"]).flops["bfloat16"] == 4 * 1000 * per_token
    d = work.lm_decode(m, [10] * 256)
    assert work.total(d["head"]).flops["bfloat16"] == 2 * 256 * 5120 * 152064


def test_shares_of_peaks():
    w = work.Work({"float32": 67e12, "bfloat16": 989e12}, 0)
    assert work.mfu_percent([w], 4.0) == pytest.approx(50.0)
    assert work.roofline_percent([w], 2.0) == pytest.approx(100.0)
    assert work.roofline_percent([], 1.0) is None
    assert work.ceil_pow2(1) == 8 and work.ceil_pow2(1500) == 2048
    assert work.ceil_pow2(4096) == 4096


def test_percentile_and_union():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 95) == pytest.approx(95.05)
    assert stats.percentile([3.0], 95) == 3.0 and stats.percentile([], 50) is None
    assert stats.union_length([(0, 2), (1, 3), (5, 6)]) == 4
    assert stats.merged([(5, 6), (0, 2), (1, 3)]) == [(0, 3), (5, 6)]
    assert math.isclose(stats.union_length([]), 0.0)
