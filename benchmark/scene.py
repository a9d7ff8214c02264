"""The benchmark's event scene: seeded dots with exact ground-truth flow.

A frozen copy, in numpy alone, of the ``dots`` pattern of the port's
synthetic loader (``data/synthetic.py``: persistent random dots, each event
a dot's position plus a 0.2 px Gaussian jitter, rounded to a pixel, with a
random polarity; per-quadrant motion), with two changes that make it a
workload and not a unit-test fixture:

* Each quadrant's dots keep a fixed speed ``speeds[q]`` (px/s) while their
  direction turns at ``2 pi / turn_period_s`` rad/s from the angle
  ``angles_deg[q]`` (the row axis at 0, the column axis at 90).  So a warm
  start from the previous frame is near the answer but never the answer,
  and every seed solves the same motion: the seed draws the dots, the
  events' times, jitter and polarities, not the work.  A dot circles its orbit centre ``c`` at radius
  ``R = speed / omega``:
  ``p(t) = c + R (sin(a0 + omega t), -cos(a0 + omega t))``, whose velocity
  is ``speed (cos, sin)`` of the angle.  The ground truth over [t1, t2] is
  the chord ``p(t2) - p(t1)``, exact for every dot of the quadrant.
* The events of each gray-frame interval are a fixed count, drawn at
  uniform times, and every orbit (with its clipped jitter) stays inside
  the sensor, so no event is dropped and every seed has the same sizes.

A dot's quadrant is that of its orbit centre; the ground truth of a pixel
is the flow of the quadrant the pixel lies in (the synthetic loader's
rule), so dots whose orbit crosses the middle lines vote near the border
with the other quadrant's motion, as in the loader.

``Sequence`` serves the generated events through the data-loader surface
that the port's eval loops read (``load_event``, ``time_to_index``,
``load_optical_flow``, ``eval_frame_time_list``, ``gt_flow_available``,
``load_calib``, ``len``).
"""

import numpy as np

JITTER_PX = 0.2  # the synthetic loader's position noise
JITTER_CLIP_PX = 1.0  # keeps every event of a dot within 1 px of its orbit
EDGE_PX = 2  # orbits keep clear of the sensor's outer rows and columns


def _rng(seed: int, stream: int) -> np.random.Generator:
    """An independent numpy generator per (seed, stream): any whole seed,
    also one beyond 64 bits."""
    return np.random.default_rng([int(stream), abs(int(seed)), int(seed < 0)])


class Sequence:
    """One generated sequence of ``n_frames`` gray-frame intervals.

    ``scene``: the configuration's scene block (``height``, ``width``,
    ``frame_hz``, ``event_rate``, ``n_dots``, ``speeds`` and ``angles_deg``
    (4 each, quadrants in the order (top-left, top-right, bottom-left,
    bottom-right)), ``turn_period_s``).  ``n_frames`` intervals follow a lead-in interval
    before the first gray frame.  The events are [n, 4] float64 (x = row, y = column,
    t in seconds, p in {0, 1}), sorted by time."""

    def __init__(self, scene: dict, seed: int, n_frames: int):
        self.height, self.width = int(scene["height"]), int(scene["width"])
        self.frame_dt = 1.0 / float(scene["frame_hz"])
        self.per_interval = int(round(float(scene["event_rate"]) * self.frame_dt))
        self.omega = 2.0 * np.pi / float(scene["turn_period_s"])
        self.speeds = np.asarray(scene["speeds"], dtype=np.float64).reshape(2, 2)
        self.radius = self.speeds / self.omega
        self.n_frames = int(n_frames)
        self.angle0 = np.radians(np.asarray(scene["angles_deg"], dtype=np.float64)).reshape(2, 2)
        rng = _rng(seed, 0)
        margin = float(self.radius.max()) + JITTER_CLIP_PX + EDGE_PX
        if 2 * margin >= min(self.height, self.width):
            raise ValueError(f"orbits of radius {self.radius.max():.1f} px do not fit a "
                             f"{self.height}x{self.width} sensor")
        n_dots = int(scene["n_dots"])
        self.centers = np.stack([rng.uniform(margin, self.height - 1 - margin, n_dots),
                                 rng.uniform(margin, self.width - 1 - margin, n_dots)], axis=1)
        self.quadrant = np.stack([self.centers[:, 0] > self.height / 2,
                                  self.centers[:, 1] > self.width / 2], axis=1).astype(np.int64)
        # gray frames at k * frame_dt, k = 0..n_frames; the events start one
        # interval earlier, so the first window's indices are valid
        self.gray_ts = np.arange(self.n_frames + 1) * self.frame_dt
        self.events = self._generate(_rng(seed, 1))
        self.left_ts = self.events[:, 2]

    def _position(self, dots: np.ndarray, t: np.ndarray) -> np.ndarray:
        """Orbit positions [n, 2] of ``dots`` at times ``t``."""
        qx, qy = self.quadrant[dots, 0], self.quadrant[dots, 1]
        r, a = self.radius[qx, qy], self.angle0[qx, qy] + self.omega * t
        return self.centers[dots] + np.stack([r * np.sin(a), -r * np.cos(a)], axis=1)

    def _generate(self, rng: np.random.Generator) -> np.ndarray:
        n, m = self.n_frames + 1, self.per_interval
        start = np.repeat(np.arange(-1, self.n_frames) * self.frame_dt, m)
        t = np.sort((start + rng.uniform(0.0, self.frame_dt, n * m)).reshape(n, m), axis=1).ravel()
        dots = rng.integers(0, len(self.centers), n * m)
        jitter = np.clip(rng.normal(0.0, JITTER_PX, (n * m, 2)), -JITTER_CLIP_PX, JITTER_CLIP_PX)
        xy = np.round(self._position(dots, t) + jitter)
        return np.concatenate([xy, t[:, None], rng.integers(0, 2, (n * m, 1)).astype(np.float64)], axis=1)

    # --- the eval loops' loader surface --------------------------------------
    gt_flow_available = True

    def __len__(self) -> int:
        return len(self.events)

    def load_event(self, start_index: int, end_index: int) -> np.ndarray:
        return np.copy(self.events[start_index:end_index])

    def time_to_index(self, time: float) -> int:
        return int(np.searchsorted(self.left_ts, time)) - 1

    def eval_frame_time_list(self) -> np.ndarray:
        return self.gray_ts

    def load_calib(self) -> dict:
        return {}

    def load_optical_flow(self, t1: float, t2: float) -> np.ndarray:
        """The exact displacement over [t1, t2]: [H, W, 2] (row, column),
        each pixel its quadrant's chord."""
        a1, a2 = self.angle0 + self.omega * t1, self.angle0 + self.omega * t2
        chord = np.stack([self.radius * (np.sin(a2) - np.sin(a1)),
                          -self.radius * (np.cos(a2) - np.cos(a1))], axis=-1)  # [2, 2, 2]
        rows = (np.arange(self.height) >= self.height // 2).astype(np.int64)
        cols = (np.arange(self.width) >= self.width // 2).astype(np.int64)
        return chord[rows[:, None], cols[None, :]]
