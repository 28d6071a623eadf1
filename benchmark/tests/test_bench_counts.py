"""The work counts at tiny shapes against counts made by hand."""

import math

import pytest

from benchmark import counts as C

WORK = dict(n=100, tiles=4, visible=30, last_slot=40, alive=50, pairs=1000,
            contrib=200, sum_nc=700, pixels=64 * 64, height=64, width=64)


def test_b1_is_bytes():
    # 4 B of b_incl for 40 slots, 52 B for 30 visible, 44 B a rank
    assert C.b1(WORK) == pytest.approx((160 + 30 * 52 + 100 * 44) / 3.35e12)


def test_b2_takes_the_larger_bound():
    ops = 19 * 1000 + 9 * 200
    nbytes = 40 * 100 + 4 * 5 + 4 * 4 * 256 * 6
    assert C.b2(WORK) == pytest.approx(max(ops / 67e12, nbytes / 3.35e12))


def test_b3():
    ops = 19 * 700 + 50 * 200
    nbytes = 2 * 40 * 100 + 8 * 100 + 4 * 11 * 4 * 256
    assert C.b3(WORK) == pytest.approx(max(ops / 67e12, nbytes / 3.35e12))


def test_b4_counts_alive_not_slots():
    assert C.b4(WORK) == pytest.approx((40 * 100 + 8 * 50 + 40 * 50)
                                       / 3.35e12)


def test_vgg16_flops_by_hand():
    # 16 x 16: conv layers at 16, 16, 8, 8, 4, 4, 4, 2, 2, 2, 1, 1, 1
    plan = [(3, 64, 16), (64, 64, 16), (64, 128, 8), (128, 128, 8),
            (128, 256, 4), (256, 256, 4), (256, 256, 4), (256, 512, 2),
            (512, 512, 2), (512, 512, 2), (512, 512, 1), (512, 512, 1),
            (512, 512, 1)]
    want = sum(2 * 9 * ci * co * s * s for ci, co, s in plan)
    assert C.conv_flops(16, 16) == want


def test_vgg16_at_512_is_160_gflop():
    assert C.conv_flops(512, 512) / 1e9 == pytest.approx(160.4, rel=1e-3)


def test_step_least_time_adds_the_parts():
    lpips = C.view_losses(WORK, "lpips")
    per_view = (C.b1(WORK) + C.sort(WORK) + C.b2(WORK) + C.b3(WORK)
                + C.b4(WORK) + C.preprocess(WORK) + lpips)
    adam = 7 * 4 * 59 * 50 / 3.35e12
    anchors = 3 * 4 * 59 * 50 / 3.35e12
    assert C.step_least_s([WORK, WORK], 2, "lpips", True) == pytest.approx(
        2 * per_view + adam + anchors)
    assert C.step_least_s([WORK], 1, "ssim", False) < C.step_least_s(
        [WORK], 1, "lpips", False)
    assert math.isfinite(C.step_least_s([WORK], 1, "ssim", False))
