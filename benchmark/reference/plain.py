"""The plain reference of what a cell's timed path produces, in plain
PyTorch: the eval window's events, the tile motion's dense flow, the
objective (warp, bilinear vote, blur, the hybrid cost with its TV term) at
a motion, and the event-masked AEE.  It imports nothing of the port and is
written from the method's definitions (the contrast-maximization
reference of Shiba et al., ECCV 2022, as ``configs/`` states it).

Every linear map (the tile upsampling, the blur, the Sobel stencils) is a
matrix product, so ``tf32=True`` computes the control: the same arithmetic
in float32 with each product's inputs rounded to TF32's 10-bit mantissa,
as tensor cores round them (``round_tf32``; explicit, so a CPU gives the
same numbers as the card).

It is the reference of every configuration whose file names none (no
``"reference"`` key), and keeps the contract of a reference module
(``compare.py``): ``reference_answers`` and ``LIMITS``, set from the
readings that ``PERF.md`` section 2 records.
"""

from typing import Optional, Tuple

import numpy as np
import torch

Tensor = torch.Tensor

EPS_CORNER = 1e-6  # floor(x + eps) picks each vote's top-left corner
OFFSETS = {"backward": 0.0, "forward": 1.0, "middle": 0.5}
# the trial steps of ``descent_gain``: the largest component's move, px/s
GAIN_STEPS = tuple(2.0**k for k in range(-8, 4))


def round_tf32(t: Tensor) -> Tensor:
    """Float32 ``t`` rounded to the nearest TF32 value (10 mantissa bits),
    ties to even."""
    bits = t.contiguous().view(torch.int32)
    bias = 0xFFF + ((bits >> 13) & 1)
    return ((bits + bias) & ~0x1FFF).view(torch.float32)


class Linear:
    """Matrix products in the reference's precision: float64, or the
    control's float32 with TF32-rounded inputs."""

    def __init__(self, tf32: bool, device):
        self.tf32 = tf32
        self.dtype = torch.float32 if tf32 else torch.float64
        self.device = torch.device(device)

    def tensor(self, a) -> Tensor:
        return torch.as_tensor(np.asarray(a), dtype=self.dtype, device=self.device)

    def mm(self, a: Tensor, b: Tensor) -> Tensor:
        if self.tf32:
            a, b = round_tf32(a), round_tf32(b)
        return a @ b

    def sandwich(self, left: Tensor, img: Tensor, right: Tensor) -> Tensor:
        """``left @ img @ right.T`` over the last two axes."""
        return self.mm(self.mm(left, img), right.transpose(0, 1))


# --- the eval window ---------------------------------------------------------
def window(events: np.ndarray, t1: float, t2: float, n_events: int) -> Tuple[np.ndarray, np.ndarray]:
    """(optimization batch, metric events) of the eval window [t1, t2] of a
    time-sorted stream (the MVSEC protocol): the metric events are those
    from the last one before t1 to the one before the last before t2; the
    batch is that index range cut to its last ``n_events`` or widened
    evenly to them, its times starting at 0."""
    ts = events[:, 2]
    i1, i2 = int(np.searchsorted(ts, t1)) - 1, int(np.searchsorted(ts, t2)) - 1
    metric = events[i1:i2]
    if i2 - i1 < n_events:
        short = n_events - (i2 - i1)
        i1, i2 = i1 - short // 2, i2 + short // 2
    elif i2 - i1 > n_events:
        i1 = i2 - n_events
    batch = events[max(i1, 0):min(i2, len(events))].copy()
    batch[:, 2] -= batch[:, 2].min()
    return batch, metric


# --- the tile motion's dense flow --------------------------------------------
def _upsample_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] half-pixel linear interpolation, clamped at the edges."""
    m = np.zeros((n_out, n_in))
    src = (np.arange(n_out) + 0.5) * n_in / n_out - 0.5
    lo = np.clip(np.floor(src).astype(int), 0, n_in - 1)
    hi = np.clip(lo + 1, 0, n_in - 1)
    w = np.clip(src - lo, 0.0, 1.0)
    np.add.at(m, (np.arange(n_out), lo), 1.0 - w)
    np.add.at(m, (np.arange(n_out), hi), w)
    return m


def finest_geometry(solver: dict, image_shape: Tuple[int, int]) -> dict:
    """The finest scale's tile grid of a pyramidal solver config: the crop
    halved ``scale - 1`` times gives the tile (= stride), the grid covers
    the crop, centred on the sensor."""
    patch = solver["patch"]
    crop = (int(patch["crop_height"]), int(patch["crop_width"]))
    level = int(patch["scale"]) - 1
    tile = (crop[0] // 2 ** level, crop[1] // 2 ** level)
    grid = (len(range(0, crop[0], tile[0])), len(range(0, crop[1], tile[1])))
    shift = ((image_shape[0] - crop[0]) // 2, (image_shape[1] - crop[1]) // 2)
    return {"tile": tile, "grid": grid, "shift": shift, "image": tuple(image_shape)}


def _axis_map(n_tiles: int, tile: int, shift: int, size: int) -> np.ndarray:
    """[size, n_tiles]: one axis of the tile grid replicate-padded by
    ``tile // 2 // tile + shift // tile + 1`` tiles, upsampled by ``tile``
    and centre-cropped to the sensor's ``size``."""
    pad = (tile // 2) // tile + shift // tile + 1
    n_pad = n_tiles + 2 * pad
    replicate = np.zeros((n_pad, n_tiles))
    replicate[np.arange(n_pad), np.clip(np.arange(n_pad) - pad, 0, n_tiles - 1)] = 1.0
    up = _upsample_matrix(n_pad, n_pad * tile) @ replicate
    first = up.shape[0] // 2 - size // 2
    return up[first:first + size]


class DenseFlow:
    """Tile motion [2, h, w] -> the dense flow [2, H, W] (px/s).  The tile
    motion is the negative of the flow (the method's convention)."""

    def __init__(self, geometry: dict, lin: Linear):
        (th, tw), (gh, gw), (sh, sw) = geometry["tile"], geometry["grid"], geometry["shift"]
        h, w = geometry["image"]
        self.lin = lin
        self.rows = lin.tensor(_axis_map(gh, th, sh, h))
        self.cols = lin.tensor(_axis_map(gw, tw, sw, w))

    def __call__(self, motion: Tensor) -> Tensor:
        return -self.lin.sandwich(self.rows, motion.to(self.lin.dtype), self.cols)


# --- images and the cost -----------------------------------------------------
def vote(x: Tensor, y: Tensor, shape: Tuple[int, int]) -> Tensor:
    """Bilinear vote of unit weights at positions (x, y) into an image:
    the four corners around floor(x + eps), corners outside dropped."""
    h, w = shape
    x0, y0 = torch.floor(x + EPS_CORNER), torch.floor(y + EPS_CORNER)
    ax, ay = x - x0, y - y0
    img = torch.zeros(h * w, dtype=x.dtype, device=x.device)
    for dx, dy, weight in ((0, 0, (1 - ax) * (1 - ay)), (1, 0, ax * (1 - ay)),
                           (0, 1, (1 - ax) * ay), (1, 1, ax * ay)):
        r, c = x0 + dx, y0 + dy
        inside = (r >= 0) & (r < h) & (c >= 0) & (c < w)
        img.index_add_(0, (r[inside] * w + c[inside]).long(), weight[inside])
    return img.reshape(h, w)


def _blur_matrix(n: int, sigma: float) -> np.ndarray:
    """[n, n]: the 3-tap Gaussian of ``sigma`` with reflect padding
    (index -1 reads 1, index n reads n - 2)."""
    taps = np.exp(-0.5 * (np.arange(-1, 2) / sigma) ** 2)
    taps /= taps.sum()
    m = np.zeros((n, n))
    for i in range(n):
        for k, tap in zip((-1, 0, 1), taps):
            j = i + k
            j = -j if j < 0 else (2 * (n - 1) - j if j > n - 1 else j)
            m[i, j] += tap
    return m


def _stencil(n: int, taps) -> np.ndarray:
    """[n, n]: the 3-tap correlation ``taps`` with zero padding."""
    m = np.zeros((n, n))
    for k, tap in zip((-1, 0, 1), taps):
        idx = np.arange(n)
        ok = (idx + k >= 0) & (idx + k < n)
        m[idx[ok], idx[ok] + k] = tap
    return m


class Sobel:
    """The 3x3 Sobel gradients of an [h, w] image, each divided by 8:
    along the rows ([-1, 0, 1] across rows, [1, 2, 1] along them) and along
    the columns."""

    def __init__(self, shape: Tuple[int, int], lin: Linear):
        h, w = shape
        self.lin = lin
        self.d_h, self.s_h = lin.tensor(_stencil(h, (-1, 0, 1))), lin.tensor(_stencil(h, (1, 2, 1)))
        self.d_w, self.s_w = lin.tensor(_stencil(w, (-1, 0, 1))), lin.tensor(_stencil(w, (1, 2, 1)))

    def __call__(self, img: Tensor) -> Tuple[Tensor, Tensor]:
        gx = self.lin.sandwich(self.d_h, img, self.s_w) / 8.0
        gy = self.lin.sandwich(self.s_h, img, self.d_w) / 8.0
        return gx, gy


def gradient_magnitude(img: Tensor, sobel: Sobel) -> Tensor:
    """mean(|Sobel(img) / 8|^2) without the outer ring."""
    gx, gy = sobel(img)
    return (gx[1:-1, 1:-1] ** 2 + gy[1:-1, 1:-1] ** 2).mean()


def total_variation(motion: Tensor, lin: Linear) -> Tensor:
    """mean |Sobel(motion) / 8| of the tile motion [2, h, w]: the row
    gradient of channel 0, the column gradient of channel 1, the row
    gradient of 1 and the column gradient of 0; the outer ring dropped
    when both sides exceed 2."""
    sobel = Sobel(tuple(motion.shape[-2:]), lin)
    ux, uy = sobel(motion[0])
    vx, vy = sobel(motion[1])
    stack = torch.stack([ux, vy, vx, uy])
    if stack.shape[-2] > 2 and stack.shape[-1] > 2:
        stack = stack[:, 1:-1, 1:-1]
    return stack.abs().mean()


class Objective:
    """The hybrid cost of one frame's optimization batch at a tile motion:
    multi-focal normalized gradient magnitude of the blurred images warped
    to t = 0, 1 and 0.5 over the blurred unwarped image, plus the weighted
    total variation of the tile motion."""

    def __init__(self, config: dict, lin: Linear):
        solver = config["solver"]
        data = config["data"]
        self.shape = (int(data["height"]), int(data["width"]))
        self.lin = lin
        self.dense = DenseFlow(finest_geometry(solver, self.shape), lin)
        weights = solver["cost_with_weight"]
        if set(weights) != {"multi_focal_normalized_gradient_magnitude", "total_variation"}:
            raise ValueError(f"the reference has no cost {sorted(weights)}")
        self.w_focal = float(weights["multi_focal_normalized_gradient_magnitude"])
        self.w_tv = float(weights["total_variation"])
        sigma = float(solver["iwe"]["blur_sigma"])
        self.blur = (lin.tensor(_blur_matrix(self.shape[0], sigma)), lin.tensor(_blur_matrix(self.shape[1], sigma)))
        self.sobel = Sobel(self.shape, lin)

    def _blurred(self, x: Tensor, y: Tensor) -> Tensor:
        return self.lin.sandwich(self.blur[0], vote(x, y, self.shape), self.blur[1])

    def prepare(self, batch: np.ndarray) -> dict:
        """The batch's event columns on the device, its times scaled to
        [0, 1] and its span in seconds."""
        dev, dt = self.lin.device, self.lin.dtype
        ev = torch.as_tensor(batch, dtype=torch.float64, device=dev)
        t = ev[:, 2]
        span = t.max() - t.min()
        x, y = ev[:, 0].to(dt), ev[:, 1].to(dt)
        return {"x": x, "y": y, "dtf": ((t - t.min()) / span).to(dt), "span": span.to(dt),
                "row": x.long(), "col": y.long()}

    def value(self, ev: dict, motion: Tensor) -> Tensor:
        """The cost of a prepared batch (``prepare``) at the tile motion, as
        a tensor that carries the motion's gradient."""
        x, y, dtf = ev["x"], ev["y"], ev["dtf"]
        flow = self.dense(motion) * ev["span"]  # the window's displacement, px
        u, v = flow[0, ev["row"], ev["col"]], flow[1, ev["row"], ev["col"]]
        g_orig = gradient_magnitude(self._blurred(x, y), self.sobel)
        g = {name: gradient_magnitude(self._blurred(x - (dtf - off) * u, y - (dtf - off) * v), self.sobel)
             for name, off in OFFSETS.items()}
        focal = g_orig / g["forward"] + g_orig / g["backward"] + 2.0 * g_orig / g["middle"]
        return self.w_focal * focal + self.w_tv * total_variation(motion.to(self.lin.dtype), self.lin)

    def __call__(self, batch: np.ndarray, motion: Tensor) -> float:
        return float(self.value(self.prepare(batch), motion))


def descent_gain(objective: Objective, ev: dict, motion: Tensor, steps=GAIN_STEPS) -> float:
    """How much of the cost one plain steepest-descent step still removes
    from the tile motion: ``(f(m) - min_a f(m + a d)) / |f(m)|``, ``d`` the
    negative gradient scaled to a largest component of 1 px/s and ``a``
    each of ``steps`` (px/s); 0 where no step lowers the cost.  A solve
    that has converged reads near 0; one that stopped short of its
    minimum, as a grid sweep without its Newton solve does, reads more."""
    m = motion.detach().to(objective.lin.dtype).clone().requires_grad_(True)
    f0 = objective.value(ev, m)
    (grad,) = torch.autograd.grad(f0, m)
    f0 = float(f0.detach())
    top = float(grad.abs().max())
    if top == 0.0:
        return 0.0
    d = -grad / top
    with torch.no_grad():
        best = min(float(objective.value(ev, m + a * d)) for a in steps)
    return max(f0 - best, 0.0) / abs(f0)


# --- the metric --------------------------------------------------------------
def event_mask(metric_events: np.ndarray, shape: Tuple[int, int], device) -> Tensor:
    """Pixels that hold an event of the eval window (events at pixel
    positions)."""
    h, w = shape
    ev = np.asarray(metric_events)
    r, c = np.floor(ev[:, 0] + EPS_CORNER).astype(np.int64), np.floor(ev[:, 1] + EPS_CORNER).astype(np.int64)
    ok = (r >= 0) & (r < h) & (c >= 0) & (c < w)
    mask = np.zeros((h, w), dtype=bool)
    mask[r[ok], c[ok]] = True
    return torch.as_tensor(mask, device=device)


def aee(gt: np.ndarray, pred: Optional[Tensor], mask: Tensor) -> float:
    """Mean end-point error over the event mask and the pixels whose GT is
    finite and nonzero in both components; ``gt`` [H, W, 2] displacement,
    ``pred`` [2, H, W] displacement (None: zero flow)."""
    g = torch.as_tensor(np.transpose(np.asarray(gt, dtype=np.float64), (2, 0, 1)), device=mask.device)
    valid = mask & torch.isfinite(g).all(0) & (g != 0).all(0)
    p = torch.zeros_like(g) if pred is None else pred.to(torch.float64)
    err = torch.sqrt(((g - p) ** 2).sum(0))[valid]
    return float(err.sum() / (valid.sum() + 1e-5))


def dense_displacement(objective: Objective, motion: Tensor, seconds: float) -> Tensor:
    """The tile motion's dense displacement over ``seconds``: [2, H, W]."""
    return objective.dense(motion) * seconds


# --- the contract of a reference module (compare.py) ----------------------------
# each number's limit: above the largest reading of sound runs, below the
# control's (TF32) and the planted faults' smallest readings (PERF.md)
LIMITS = {"loss_gap": 5e-6, "aee_gap": 2e-6, "aee_share": 0.8, "descent_gain": 6.5e-4}


def reference_answers(answers, stream: np.ndarray, scene, config: dict, device, tf32: bool = False) -> list:
    """The reference's (loss, AEE, zero-flow AEE, descent gain) of each
    frame at the program's motion: float64, or the control's TF32 products
    (``tf32``; no descent gain, NaN).  ``scene.load_optical_flow`` gives
    the ground truth."""
    lin = Linear(tf32, device)
    objective = Objective(config, lin)
    n_events = int(config["data"]["n_events_per_batch"])
    out = []
    for a in answers:
        batch, metric = window(stream, a.t1, a.t2, n_events)
        motion = a.motion.to(device=lin.device, dtype=torch.float64)
        mask = event_mask(metric, objective.shape, lin.device)
        gt = scene.load_optical_flow(a.t1, a.t2)
        pred = dense_displacement(objective, motion, a.t2 - a.t1)
        ev = objective.prepare(batch)
        loss = float(objective.value(ev, motion))
        gain = float("nan") if tf32 else descent_gain(objective, ev, motion)
        out.append((loss, aee(gt, pred, mask), aee(gt, None, mask), gain))
    return out
