"""The yardstick's counters against hand counts at small shapes."""

import pytest

from bench_port.harness import work
from bench_port.tests.tiny import tiny_config


def test_vgg_convs_at_32():
    convs = work.vgg_convs(32)
    assert [c[:4] for c in convs[:3]] == [(32, 32, 3, 64), (32, 32, 64, 64),
                                          (16, 16, 64, 128)]
    assert [c[4] for c in convs] == [False, True, False, True, False,
                                     False, True, False, False, True,
                                     False, False, True]
    assert convs[-1][:4] == (2, 2, 512, 512)
    hand = 2 * 9 * (32 * 32 * (3 * 64 + 64 * 64)
                    + 16 * 16 * (64 * 128 + 128 * 128)
                    + 8 * 8 * (128 * 256 + 2 * 256 * 256)
                    + 4 * 4 * (256 * 512 + 2 * 512 * 512)
                    + 2 * 2 * 3 * 512 * 512)
    assert work.trunk_flops(convs) == hand


def test_flagship_trunk_is_vgg16():
    assert work.trunk_flops(work.vgg_convs(224)) == pytest.approx(30.69e9,
                                                             rel=1e-3)


def test_detection_and_pair_flops():
    m = tiny_config()["config"]["model"]
    # PointNet 4->16->32 on 16 points, proj 32->32; gate 64->2; two
    # projections 32->32; det head 32->16->1.
    hand = 2 * (16 * (4 * 16 + 16 * 32) + 32 * 32 + 64 * 2 + 2 * 32 * 32
                + 32 * 16 + 16)
    assert work.detection_flops(m) == hand
    # 3 branches of 32->16->1 over 10 pairs, new/end 33->16->1 over 7 dets.
    assert work.pair_flops(m, 10, 7) == 2 * 3 * 10 * (32 * 16 + 16) \
        + 2 * 7 * (33 * 16 + 16)
    # Width 1/8: the last three stages hold 32, 64, 64 channels.
    assert work.head_flops(m) == 2 * ((32 + 64 + 64) * 16 + 3 * 16 * 32)


def test_bounds():
    m = tiny_config()["config"]["model"]
    t = work.model_seconds(m, 2, 2, 10, 7)
    assert t == pytest.approx(
        (2 * work.trunk_flops(work.vgg_convs(32, 0.125))
         + 2 * work.head_flops(m)
         + 2 * work.detection_flops(m) + work.pair_flops(m, 10, 7))
        / work.PEAK_BF16)
    assert work.model_seconds(m, 2, 2, 10, 7, passes=3) == pytest.approx(3 * t)
    # conv_0 at 224: 3 -> 64 channels, no pool, bound by its bytes.
    conv0 = work.vgg_convs(224)[:1]
    ops = 2.0 * 224 * 224 * 9 * 3 * 64
    nbytes = 224 * 224 * 3 + 64 * 9 * 3 + 8 * 64 + 224 * 224 * 64
    assert work.int8_trunk_bound_s(1, conv0) == max(
        ops / work.PEAK_INT8, nbytes / work.PEAK_BYTES) == \
        nbytes / work.PEAK_BYTES
    # conv_1 with its pool: the output is a quarter.
    conv1 = work.vgg_convs(224)[1:2]
    nb1 = 224 * 224 * 64 + 64 * 9 * 64 + 8 * 64 + 112 * 112 * 64
    assert work.int8_trunk_bound_s(2, conv1) == pytest.approx(max(
        2 * 2.0 * 224 * 224 * 9 * 64 * 64 / work.PEAK_INT8,
        (2 * 224 * 224 * 64 + 64 * 9 * 64 + 8 * 64 + 2 * 112 * 112 * 64)
        / work.PEAK_BYTES))
    assert nb1 > 0
    a = work.affinity_bound_s(m, 10, 7, 1, 8)
    assert a >= work.pair_flops(m, 10, 7) / work.PEAK_BF16
