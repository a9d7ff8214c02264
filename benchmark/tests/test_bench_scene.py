"""The benchmark's scene: deterministic per seed, fixed sizes, exact GT."""

import numpy as np

from benchmark.scene import Sequence

SCENE = {"height": 40, "width": 56, "frame_hz": 20.0, "event_rate": 4000.0, "n_dots": 30,
         "speeds": [12.0, 8.0, 10.0, 6.0],
         "angles_deg": [30.0, -100.0, 170.0, 60.0], "turn_period_s": 2.0}


def test_same_seed_same_events_other_seed_other_events():
    big = 2**31 + 12345
    a, b, c = Sequence(SCENE, big, 4), Sequence(SCENE, big, 4), Sequence(SCENE, big + 1, 4)
    np.testing.assert_array_equal(a.events, b.events)
    assert a.events.shape == c.events.shape
    assert not np.array_equal(a.events, c.events)
    np.testing.assert_array_equal(a.load_optical_flow(0.05, 0.1), b.load_optical_flow(0.05, 0.1))


def test_every_interval_has_the_same_count_inside_the_sensor():
    seq = Sequence(SCENE, 5, 6)
    per = seq.per_interval
    assert per == 200 and len(seq) == 7 * per  # the lead-in interval and 6 more
    t = seq.events[:, 2]
    assert np.all(np.diff(t) >= 0)
    for k in range(-1, 6):
        inside = (t >= k * seq.frame_dt) & (t < (k + 1) * seq.frame_dt)
        assert inside.sum() == per
    assert seq.events[:, 0].min() >= 0 and seq.events[:, 0].max() <= SCENE["height"] - 1
    assert seq.events[:, 1].min() >= 0 and seq.events[:, 1].max() <= SCENE["width"] - 1
    assert set(np.unique(seq.events[:, 3])) <= {0.0, 1.0}
    # the eval loop's first window has valid indices
    assert seq.time_to_index(seq.gray_ts[0]) >= 0


def test_ground_truth_is_each_dots_chord():
    seq = Sequence(SCENE, 9, 4)
    t1, t2 = 0.07, 0.16
    gt = seq.load_optical_flow(t1, t2)
    dots = np.arange(len(seq.centers))
    move = seq._position(dots, np.full(len(dots), t2)) - seq._position(dots, np.full(len(dots), t1))
    for d in dots:
        r, c = np.round(seq._position(np.array([d]), np.array([t1]))[0]).astype(int)
        q_pixel = (r >= SCENE["height"] // 2, c >= SCENE["width"] // 2)
        if q_pixel == tuple(seq.quadrant[d].astype(bool)):
            np.testing.assert_allclose(gt[r, c], move[d], rtol=0, atol=1e-12)
    # the speed is each quadrant's: the chord over a short interval is speed * dt
    dt = 1e-6
    short = seq.load_optical_flow(0.1, 0.1 + dt)
    speeds = np.hypot(short[..., 0], short[..., 1]) / dt
    np.testing.assert_allclose(speeds[0, 0], SCENE["speeds"][0], rtol=1e-5)
    np.testing.assert_allclose(speeds[-1, -1], SCENE["speeds"][3], rtol=1e-5)


def test_events_follow_their_dots():
    seq = Sequence(SCENE, 3, 2)
    # regenerate the positions without the jitter: every event lies within
    # the clipped jitter (plus rounding) of its dot's orbit
    ev = seq.events
    pos = np.stack([seq._position(np.array([d]), ev[:, 2]) for d in range(len(seq.centers))], 0)
    dist = np.abs(pos - ev[None, :, :2]).max(-1).min(0)
    assert dist.max() <= 1.5
