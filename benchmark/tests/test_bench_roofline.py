"""The roofline count against hand-computed bytes and operations."""

import pytest

from benchmark import roofline


def test_call_bytes_and_seconds_by_hand():
    n, h, w = 1000, 10, 20
    events = 4 * n * 4
    flow = 2 * h * w * 4
    images = 3 * h * w * 4
    assert roofline.call_bytes("fwd", n, h, w) == events + flow + images == 20000
    assert roofline.call_bytes("bwd", n, h, w) == events + 2 * flow + images
    assert roofline.call_bytes("jvp", n, h, w) == events + 2 * flow + images
    assert roofline.call_bytes("hvp_bwd", n, h, w) == events + 2 * flow + images
    assert roofline.call_seconds("fwd", n, h, w) == pytest.approx(max(20000 / 3.35e12, 30 * n * 3 / 67e12))
    # 16 bytes and 3 * 45 operations per event: the event arrays bound a
    # large call on a tiny image (below the H100's 20 FLOP per byte)
    big = 10**7
    assert roofline.call_seconds("jvp", big, 2, 2) == pytest.approx((16 * big + 2 * 32 + 48) / 3.35e12)


def test_solve_seconds_sums_launches_per_scale_and_frame():
    stats = {"events": {1: 100, 2: 400},
             "launches": {1: {"fwd": 3, "bwd": 2, "vote": 9, "voxel_fwd": 5}, 2: {"fwd": 1, "jvp": 0}}}
    want = (3 * roofline.call_seconds("fwd", 100, 8, 8) + 2 * roofline.call_seconds("bwd", 100, 8, 8)
            + roofline.call_seconds("fwd", 400, 8, 8))
    assert roofline.solve_seconds(stats, (8, 8)) == pytest.approx(want)
    batch = {"events": {1: [100, 300]}, "launches": {1: {"batched_fwd": 2, "batched_hvp_bwd": 1}}}
    want = (2 * (roofline.call_seconds("fwd", 100, 8, 8) + roofline.call_seconds("fwd", 300, 8, 8))
            + roofline.call_seconds("hvp_bwd", 100, 8, 8) + roofline.call_seconds("hvp_bwd", 300, 8, 8))
    assert roofline.solve_seconds(batch, (8, 8)) == pytest.approx(want)
