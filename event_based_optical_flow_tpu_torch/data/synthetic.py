"""Synthetic sequence loader: dataset-free end-to-end runs and tests (port
of ``event_based_optical_flow_tpu/data/synthetic.py``; byte-identical event
streams and GT for the same config).

Generates a deterministic event stream from a moving sparse-edge scene
with exact GT displacement — exercising the full DataLoaderBase contract
(load_event / load_optical_flow / time_to_index / eval_frame_time_list)
without any files on disk.  No reference counterpart (the reference
requires a downloaded MVSEC hdf5); this makes the eval pipeline
self-contained.

Scene families (``data.scene``, used by the accuracy parity study —
tools/parity_study.py):
  * ``quadrants`` (default): piecewise-constant per-quadrant flow
  * ``disc``: two halves with opposite translations (sharp discontinuity)
  * ``rot``: rigid rotation about the image center, rate ``omega`` rad/s
    (dense flow varies linearly with radius; closed-form advection)
  * ``zoom``: exponential expansion ``zoom_rate`` 1/s about the center
  * ``rot3d``: calibrated 3-DoF camera rotation ``omega3`` rad/s
    (exact ray rotation + pinhole projection, focal ``focal`` px; the
    GT for the "3-rotation" global motion model)
``noise_fraction`` mixes in uniform random (scene-independent) events;
``event_rate`` controls density.  GT displacement is the exact particle
displacement of each pixel over the window (not velocity x dt), so the
AEE floor reflects only the estimator, not the scene model.
"""

import logging
import zlib

import numpy as np

from .base import DataLoaderBase

logger = logging.getLogger(__name__)


class SyntheticDataLoader(DataLoaderBase):
    NAME = "synthetic"

    def __init__(self, config: dict = {}):
        self._HEIGHT = config["height"]
        self._WIDTH = config["width"]
        self.config = config
        self.gt_flow_available = True
        self.auto_undistort = False
        self.duration = float(config.get("duration", 2.0))
        self.event_rate = float(config.get("event_rate", 200_000.0))
        self.flow_max = float(config.get("flow_max", 15.0))
        self.n_frames = int(config.get("n_frames", 20))
        self.seed = int(config.get("seed", 7))
        self.scene = str(config.get("scene", "quadrants"))
        self.omega = float(config.get("omega", 0.2))  # rad/s (scene: rot)
        self.zoom_rate = float(config.get("zoom_rate", 0.15))  # 1/s (scene: zoom)
        # scene "rot3d": calibrated camera rotation (rad/s, camera frame:
        # x right=col, y down=row, z forward); "focal" in px
        self.omega3 = np.asarray(config.get("omega3", [0.05, -0.05, 0.4]), np.float64)
        self.focal = float(config.get("focal", (self._HEIGHT + self._WIDTH) / 2.0))
        self.noise_fraction = float(config.get("noise_fraction", 0.0))
        # "lattice" (default): jittered sparse-edge lattice.  "dots":
        # persistent random dots — APERIODIC; lattice patterns alias
        # translations by period/dt, which breaks recovery studies (the
        # round-1 lesson; use dots for any accuracy measurement)
        self.pattern = str(config.get("pattern", "lattice"))
        self.n_dots = int(config.get("n_dots", 1200))
        # gt_advection: serve GT like MVSEC does — per-GT-frame
        # displacement stacks advected across the eval window via
        # flow.gt.estimate_corresponding_gt_flow (ref flow_utils.py:
        # 763-839) instead of the closed form.  This drives the dt>1
        # protocol (events spanning multiple GT frames) end-to-end with
        # the closed form available as truth (see _exact_flow).
        self.gt_advection = bool(config.get("gt_advection", False))

    def set_sequence(self, sequence_name: str, undistort: bool = False) -> None:
        self.sequence_name = sequence_name
        # deterministic name hash: Python's str hash is salted per process
        # (PYTHONHASHSEED), which silently made every run a different scene
        name_hash = zlib.crc32(sequence_name.encode()) % 1000
        rng = np.random.default_rng(self.seed + name_hash)
        H, W = self._HEIGHT, self._WIDTH
        n = int(self.duration * self.event_rate)

        # per-quadrant constant flow field (px/s), pattern velocity = flow
        self.flow_quadrants = rng.uniform(-self.flow_max, self.flow_max, (2, 2, 2))
        self.center = ((H - 1) / 2.0, (W - 1) / 2.0)
        t = np.sort(rng.uniform(0, self.duration, n))
        if self.pattern == "dots":
            dx = rng.uniform(2, H - 2, self.n_dots)
            dy = rng.uniform(2, W - 2, self.n_dots)
            idx = rng.integers(0, self.n_dots, n)
            x0 = dx[idx] + rng.normal(0, 0.2, n)
            y0 = dy[idx] + rng.normal(0, 0.2, n)
        else:
            # sparse edge scene: positions snapped to a jittered lattice
            x0 = np.round(rng.uniform(2, H - 2, n) / 6) * 6 + rng.normal(0, 0.3, n)
            y0 = np.round(rng.uniform(2, W - 2, n) / 8) * 8 + rng.normal(0, 0.3, n)
        if self.scene == "quadrants":
            qx = (x0 > H / 2).astype(int)
            qy = (y0 > W / 2).astype(int)
            u = self.flow_quadrants[qx, qy, 0]
            v = self.flow_quadrants[qx, qy, 1]
            x = x0 + t * u
            y = y0 + t * v
        elif self.scene == "disc":
            # two halves (by width) with opposite translations: the sharp
            # discontinuity scene of the time-aware study
            sign = np.where(y0 > W / 2, 1.0, -1.0)
            x = x0 + t * sign * self.flow_max
            y = y0 + t * sign * (-0.7 * self.flow_max)
        elif self.scene == "rot":
            # rigid rotation about the center: pos(t) = c + R(w t)(p0 - c)
            cx, cy = self.center
            ang = self.omega * t
            ca, sa = np.cos(ang), np.sin(ang)
            rx, ry = x0 - cx, y0 - cy
            x = cx + ca * rx - sa * ry
            y = cy + sa * rx + ca * ry
        elif self.scene == "zoom":
            # exponential expansion: pos(t) = c + exp(s t)(p0 - c)
            cx, cy = self.center
            g = np.exp(self.zoom_rate * t)
            x = cx + g * (x0 - cx)
            y = cy + g * (y0 - cy)
        elif self.scene == "rot3d":
            # calibrated camera rotation: scene directions are fixed, the
            # camera frame rotates with omega3, so each dot's ray evolves
            # exactly as ray(t) = exp(-[omega3]x t) ray(0) (the projected
            # small-motion limit is ops/warp.flow_from_rotation's field)
            x, y = self._rotate_pixels(x0, y0, t)
        else:
            raise NotImplementedError(f"synthetic scene {self.scene!r} not implemented")
        if self.noise_fraction > 0:
            # scene-independent clutter: a random subset becomes uniform
            # spatial noise (timestamps kept, so rates stay comparable)
            noisy = rng.random(n) < self.noise_fraction
            x = np.where(noisy, rng.uniform(0, H - 1, n), x)
            y = np.where(noisy, rng.uniform(0, W - 1, n), y)
        ok = (x >= 0) & (x < H - 1) & (y >= 0) & (y < W - 1)
        ev = np.stack([np.round(x), np.round(y), t, rng.integers(0, 2, n)], axis=1)[ok]
        self.events = ev[np.argsort(ev[:, 2], kind="stable")]
        self.left_ts = self.events[:, 2]
        self.min_ts = 0.0
        self.max_ts = self.duration
        self.data_duration = self.duration
        self.gray_ts = np.linspace(0.02, self.duration - 0.02, self.n_frames)
        self._gt_adv_cache = None

    def _calib4(self):
        """(f_row, f_col, c_row, c_col) of the synthetic pinhole."""
        return self.focal, self.focal, (self._HEIGHT - 1) / 2.0, (self._WIDTH - 1) / 2.0

    def _rotate_pixels(self, x_row, y_col, dt):
        """Pixel positions after rotating the camera by omega3 for dt
        (vectorized Rodrigues on the unprojected rays; dt may be
        per-element)."""
        fr, fc, cr, cc = self._calib4()
        rays = np.stack(
            [(y_col - cc) / fc, (x_row - cr) / fr, np.ones_like(x_row)], axis=-1
        )
        nw = float(np.linalg.norm(self.omega3))
        if nw < 1e-12:
            return x_row, y_col
        k = -self.omega3 / nw  # exp(-[w]x t) = rotation by |w| t about -w
        a = np.asarray(nw * dt)[..., None]
        kxv = np.cross(np.broadcast_to(k, rays.shape), rays)
        kdv = (rays @ k)[..., None]
        r = rays * np.cos(a) + kxv * np.sin(a) + k * kdv * (1.0 - np.cos(a))
        X, Y = r[..., 0] / r[..., 2], r[..., 1] / r[..., 2]
        return cr + fr * Y, cc + fc * X

    def __len__(self):
        return len(self.events)

    def load_event(self, start_index: int, end_index: int, cam: str = "left") -> np.ndarray:
        return np.copy(self.events[start_index:end_index])

    def index_to_time(self, index: int) -> float:
        return float(self.left_ts[min(index, len(self.left_ts) - 1)])

    def time_to_index(self, time: float) -> int:
        return int(np.searchsorted(self.left_ts, time)) - 1

    def eval_frame_time_list(self):
        return self.gray_ts

    def gt_time_list(self):
        """The GT timestamps: the gray frames' (the GT is exact at any
        window)."""
        return self.gray_ts

    def load_optical_flow(self, t1: float, t2: float) -> np.ndarray:
        """GT displacement over [t1, t2]: [H, W, 2] (height, width).

        Default: the exact closed form (_exact_flow).  With
        ``gt_advection: true`` the GT is served the MVSEC way: one
        displacement frame per gray-frame interval, advected across the
        window by flow.gt.estimate_corresponding_gt_flow — so eval_dt>1
        exercises the multi-GT-frame advection path end-to-end."""
        if self.gt_advection:
            from ..flow.gt import estimate_corresponding_gt_flow

            U_all, V_all, ts = self._gt_stacks()
            U, V = estimate_corresponding_gt_flow(U_all, V_all, ts, t1, t2)
            return np.stack((V, U), axis=2)
        return self._exact_flow(t1, t2)

    def _gt_stacks(self):
        """Per-GT-frame displacement stacks in the MVSEC/EV-FlowNet layout
        (U = width/x component, V = height/y component), one frame per
        gray-frame interval."""
        if self._gt_adv_cache is None:
            ts = np.asarray(self.gray_ts)
            U, V = [], []
            for i in range(len(ts) - 1):
                f = self._exact_flow(ts[i], ts[i + 1])
                V.append(f[..., 0])
                U.append(f[..., 1])
            self._gt_adv_cache = (np.stack(U), np.stack(V), ts)
        return self._gt_adv_cache

    def _exact_flow(self, t1: float, t2: float) -> np.ndarray:
        """Exact GT displacement over [t1, t2]: [H, W, 2] (height, width).

        For rot/zoom this is the closed-form particle displacement of the
        pixel's current occupant (the velocity fields are time-invariant
        in space, so it is exact, not velocity x dt)."""
        H, W = self._HEIGHT, self._WIDTH
        dt = t2 - t1
        flow = np.zeros((H, W, 2))
        if self.scene == "quadrants":
            for qx in (0, 1):
                for qy in (0, 1):
                    sx = slice(0, H // 2) if qx == 0 else slice(H // 2, H)
                    sy = slice(0, W // 2) if qy == 0 else slice(W // 2, W)
                    flow[sx, sy, 0] = self.flow_quadrants[qx, qy, 0] * dt
                    flow[sx, sy, 1] = self.flow_quadrants[qx, qy, 1] * dt
            return flow
        if self.scene == "disc":
            half = W // 2
            flow[:, half:, 0] = self.flow_max * dt
            flow[:, half:, 1] = -0.7 * self.flow_max * dt
            flow[:, :half, 0] = -self.flow_max * dt
            flow[:, :half, 1] = 0.7 * self.flow_max * dt
            return flow
        cx, cy = self.center
        rx, ry = np.meshgrid(
            np.arange(H, dtype=np.float64) - cx,
            np.arange(W, dtype=np.float64) - cy,
            indexing="ij",
        )
        if self.scene == "rot":
            ca, sa = np.cos(self.omega * dt), np.sin(self.omega * dt)
            flow[:, :, 0] = ca * rx - sa * ry - rx
            flow[:, :, 1] = sa * rx + ca * ry - ry
            return flow
        if self.scene == "zoom":
            g = np.exp(self.zoom_rate * dt) - 1.0
            flow[:, :, 0] = g * rx
            flow[:, :, 1] = g * ry
            return flow
        if self.scene == "rot3d":
            rows = np.broadcast_to(np.arange(H, dtype=np.float64)[:, None], (H, W))
            cols = np.broadcast_to(np.arange(W, dtype=np.float64)[None, :], (H, W))
            x2, y2 = self._rotate_pixels(rows.ravel(), cols.ravel(), dt)
            flow[:, :, 0] = x2.reshape(H, W) - rows
            flow[:, :, 1] = y2.reshape(H, W) - cols
            return flow
        raise NotImplementedError(f"synthetic scene {self.scene!r} not implemented")

    def load_calib(self) -> dict:
        """Synthetic pinhole intrinsics (OpenCV K; consumed by the
        calibrated motion models, e.g. "3-rotation")."""
        fr, fc, cr, cc = self._calib4()
        return {"K": np.array([[fc, 0.0, cc], [0.0, fr, cr], [0.0, 0.0, 1.0]])}
