"""Event warping and the global motion models (port of
``event_based_optical_flow_tpu/ops/warp.py``).

* ``warp_2dof`` — global 2-DoF translation ``x' = x + dt * tx`` (the
  per-patch init sweep).
* ``warp_dense_flow`` — per-pixel flow ``x' = x - dt * u(x, y)`` gathered at
  the clipped integer event position (the FWL metric).
* ``warp_voxel_flow`` — the same with a ``[T, 2, H, W]`` flow voxel, each
  event reading its time bin's slice (the time-aware FWL metric).
* ``warp_voxel_flow_streaming`` — the time-aware warp of a ``[2, H, W]``
  flow propagated bin by bin (Burgers or upwind), each bin's events
  warped by the current field: the ``[T, 2, H, W]`` voxel is never built.
* ``multi_direction_dense_warp`` — one flow gather, several reference times
  (the plain version of the objective's warps).
* ``flow_from_2d_translation``, ``flow_from_similarity``,
  ``flow_from_rotation`` — the dense ``[..., 2, H, W]`` field of a global
  motion model's ``[..., P]`` parameters (the global solver's objective),
  each linear in the parameters; events advect with +g, the flow is -g.
  ``calib_tuple`` reads a calibration's ``K``.
* ``Warp`` — the JAX package's facade: parameter names, conversions, the
  model's field and ``warp_event``'s dispatch.

Events are ``[..., n, 4]`` tensors ``(x=height, y=width, t, p)``; an
optional ``[..., n]`` weight mask keeps padded rows out of the masked
time statistics.  Warped events carry ``dt`` in the time column.
"""

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

Tensor = torch.Tensor


def _masked_min(x: Tensor, weights: Optional[Tensor]) -> Tensor:
    if weights is None:
        return x.amin(dim=-1)
    big = torch.finfo(x.dtype).max
    return torch.where(weights > 0, x, x.new_tensor(big)).amin(dim=-1)


def _masked_max(x: Tensor, weights: Optional[Tensor]) -> Tensor:
    if weights is None:
        return x.amax(dim=-1)
    small = torch.finfo(x.dtype).min
    return torch.where(weights > 0, x, x.new_tensor(small)).amax(dim=-1)


_NAMED_DIRECTIONS = {"first": 0.0, "middle": 0.5, "last": 1.0, "before": -1.0, "after": 2.0}


def calculate_reftime(
    events: Tensor,
    direction: Union[str, float] = "first",
    weights: Optional[Tensor] = None,
) -> Tensor:
    """Reference time for the warp: a float in the [0, 1] convention or one
    of 'first' | 'middle' | 'last' | 'before' (-1.0) | 'after' (2.0)."""
    t = events[..., 2]
    tmin = _masked_min(t, weights)
    tmax = _masked_max(t, weights)
    if isinstance(direction, float):
        return tmin + (tmax - tmin) * direction
    if direction == "first":
        return tmin
    if direction == "last":
        return tmax
    if direction in _NAMED_DIRECTIONS:
        return tmin + (tmax - tmin) * _NAMED_DIRECTIONS[direction]
    raise ValueError(f"direction should be first/middle/last/before/after or float, got {direction}")


def calculate_dt(
    events: Tensor,
    reference_time: Tensor,
    normalize_t: bool,
    time_period: Optional[Tensor] = None,
    weights: Optional[Tensor] = None,
) -> Tensor:
    """dt = t - ref, optionally normalized so that max - min = 1."""
    t = events[..., 2]
    ref = torch.as_tensor(reference_time, dtype=t.dtype, device=t.device)
    if ref.ndim == t.ndim - 1:
        ref = ref[..., None]
    dt = t - ref
    if normalize_t:
        if time_period is None:
            period = _masked_max(dt, weights) - _masked_min(dt, weights)
        else:
            period = torch.as_tensor(time_period, dtype=t.dtype, device=t.device)
        if period.ndim == t.ndim - 1:
            period = period[..., None]
        dt = dt / period
    return dt


def _replace_xy_t(events: Tensor, x: Tensor, y: Tensor, dt: Tensor) -> Tensor:
    return torch.stack([x, y, dt, events[..., 3].expand_as(x)], dim=-1)


def warp_2dof(
    events: Tensor,
    translation: Tensor,
    reference_time: Tensor,
    normalize_t: bool = False,
    time_period: Optional[Tensor] = None,
    weights: Optional[Tensor] = None,
) -> Tensor:
    """Global 2-DoF translation warp: x' = x + dt*tx, y' = y + dt*ty.

    ``translation`` is ``[..., 2]``; its leading dims broadcast against the
    event batch dims (e.g. events ``[P, 1, n, 4]`` with translations
    ``[P, K, 2]`` warp every patch by each of its K candidates)."""
    dt = calculate_dt(events, reference_time, normalize_t, time_period, weights)
    tx = translation[..., 0, None]
    ty = translation[..., 1, None]
    x = events[..., 0] + dt * tx
    y = events[..., 1] + dt * ty
    return _replace_xy_t(events, x, y, dt.expand_as(x))


def _gather_flow_clipped(flow: Tensor, events: Tensor, image_size: Tuple[int, int]):
    """(u, v) of a ``[..., 2, H, W]`` flow at the clipped integer positions
    of ``[..., n, 4]`` events (batch axes broadcast); a ``gather``, whose
    backward is deterministic on the GPU."""
    h, w = image_size
    ix = events[..., 0].to(torch.int64).clamp(0, h - 1)
    iy = events[..., 1].to(torch.int64).clamp(0, w - 1)
    lin = ix * w + iy
    flat = flow.reshape(flow.shape[:-3] + (2, h * w))
    batch = torch.broadcast_shapes(flat.shape[:-2], lin.shape[:-1])
    index = lin[..., None, :].expand(batch + (2, lin.shape[-1]))
    uv = torch.gather(flat.expand(batch + flat.shape[-2:]), -1, index)
    return uv[..., 0, :], uv[..., 1, :]


def warp_dense_flow(
    events: Tensor,
    flow: Tensor,
    reference_time: Tensor,
    image_size: Tuple[int, int],
    normalize_t: bool = False,
    weights: Optional[Tensor] = None,
) -> Tensor:
    """Dense-flow warp of ``[..., n, 4]`` events with a ``[..., 2, H, W]``
    flow: x' = x - dt * flow[..., 0, x, y]."""
    dt = calculate_dt(events, reference_time, normalize_t, weights=weights)
    u, v = _gather_flow_clipped(flow, events, image_size)
    return _replace_xy_t(events, events[..., 0] - dt * u, events[..., 1] - dt * v, dt)


def warp_voxel_flow(
    events: Tensor,
    flow_voxel: Tensor,
    reference_time: Tensor,
    image_size: Tuple[int, int],
    normalize_t: bool = False,
    weights: Optional[Tensor] = None,
) -> Tensor:
    """Time-aware warp of [n, 4] events with a [T, 2, H, W] flow voxel.
    Bin edges are ``t_min + k/T (t_max - t_min)``, the last bin open-ended:
    an event's bin is ``clip(floor((dt - t_min) / (t_max - t_min) T))`` of
    its (masked) dt; its (u, v) come from that bin's slice at the CLIPPED
    integer position, as ``warp_dense_flow`` gathers them (the fused
    kernel instead reads zero outside the image)."""
    dt = calculate_dt(events, reference_time, normalize_t, weights=weights)
    n_bins = flow_voxel.shape[0]
    h, w = image_size
    t_min = _masked_min(dt, weights)
    t_max = _masked_max(dt, weights)
    span = torch.where(t_max > t_min, t_max - t_min, torch.ones_like(t_max))
    bin_id = torch.floor((dt - t_min) / span * n_bins).to(torch.int64).clamp(0, n_bins - 1)
    ix = events[..., 0].to(torch.int64).clamp(0, h - 1)
    iy = events[..., 1].to(torch.int64).clamp(0, w - 1)
    flat = flow_voxel.reshape(n_bins, 2, -1)
    lin = ix * w + iy
    u = flat[bin_id, 0, lin]
    v = flat[bin_id, 1, lin]
    return _replace_xy_t(events, events[..., 0] - dt * u, events[..., 1] - dt * v, dt)


def warp_voxel_flow_streaming(
    events: Tensor,
    flow0: Tensor,
    n_time_bin: int,
    reference_time: Tensor,
    image_size: Tuple[int, int],
    normalize_t: bool = False,
    weights: Optional[Tensor] = None,
    scheme: str = "burgers",
) -> Tensor:
    """Time-aware warp of ``[n, 4]`` events that propagates the ``[2, H, W]``
    flow one bin at a time (``scheme``: ``burgers`` or ``upwind``,
    ``flow/voxel.py``'s steps of 1 / ``n_time_bin``) and warps each bin's
    events with the current field, holding one ``[2, H, W]`` field at a
    time instead of the ``[T, 2, H, W]`` voxel.  Bins split the masked
    ``dt`` range as ``warp_voxel_flow``'s do.  The JAX package's semantics
    (its reference's "optimized" voxel warp): the flow is propagated once
    *before* bin 0 is consumed, so bin k reads the (k+1)-step field, where
    ``construct_dense_flow_voxel(t0_location='first')``'s bin 0 is the
    unpropagated flow.  An unknown ``scheme`` raises ``ValueError`` (the
    JAX package runs upwind for any name but ``burgers``)."""
    from ..flow.voxel import burgers_step, upwind_step

    steps = {"burgers": burgers_step, "upwind": upwind_step}
    if scheme not in steps:
        raise ValueError(f"scheme must be one of {tuple(steps)}, got {scheme!r}")
    h, w = image_size
    dt = calculate_dt(events, reference_time, normalize_t, weights=weights)
    t_min = _masked_min(dt, weights)
    t_max = _masked_max(dt, weights)
    span = torch.where(t_max > t_min, t_max - t_min, torch.ones_like(t_max))
    bin_id = torch.floor((dt - t_min) / span * n_time_bin).to(torch.int64).clamp(0, n_time_bin - 1)
    ix = events[..., 0].to(torch.int64).clamp(0, h - 1)
    iy = events[..., 1].to(torch.int64).clamp(0, w - 1)
    lin = ix * w + iy
    u = torch.zeros_like(dt)
    v = torch.zeros_like(dt)
    flow = flow0
    for k in range(n_time_bin):
        flow = steps[scheme](flow, 1.0 / n_time_bin)
        flat = flow.reshape(2, -1)
        in_bin = bin_id == k
        u = torch.where(in_bin, flat[0, lin], u)
        v = torch.where(in_bin, flat[1, lin], v)
    return _replace_xy_t(events, events[..., 0] - dt * u, events[..., 1] - dt * v, dt)


def multi_direction_dense_warp(
    events: Tensor,
    flow: Tensor,
    directions: Sequence[float],
    image_size: Tuple[int, int],
    weights: Optional[Tensor] = None,
):
    """Warp one [n, 4] event set to several reference times (floats in the
    [0, 1] convention) with a single flow gather; normalize_t semantics
    (dt scaled so that max - min = 1) are built in.  Returns a list of
    warped event tensors, one per direction."""
    t = events[..., 2]
    t_min = _masked_min(t, weights)
    t_max = _masked_max(t, weights)
    span = torch.where(t_max > t_min, t_max - t_min, torch.ones_like(t_max))
    u, v = _gather_flow_clipped(flow, events, image_size)
    out = []
    for d in directions:
        ref = t_min + (t_max - t_min) * d
        dt = (t - ref) / span
        out.append(_replace_xy_t(events, events[..., 0] - dt * u, events[..., 1] - dt * v, dt))
    return out


def calib_tuple(image_size: Tuple[int, int], calib_param=None) -> Tuple[float, float, float, float]:
    """(f_row, f_col, c_row, c_col) from a calibration dict with a 3x3
    ``K`` in OpenCV's layout (K[0,0] = f_col, K[0,2] = c_col, K[1,1] =
    f_row, K[1,2] = c_row: the event x axis is the image ROW).  Without
    one, a generic pinhole: f = (H + W) / 2, principal point at the image
    center."""
    if calib_param and "K" in calib_param:
        K = np.asarray(calib_param["K"], dtype=np.float64)
        return float(K[1, 1]), float(K[0, 0]), float(K[1, 2]), float(K[0, 2])
    h, w = image_size
    f = (h + w) / 2.0
    return f, f, (h - 1) / 2.0, (w - 1) / 2.0


def _grid(n: int, motion: Tensor) -> Tensor:
    """0..n-1 in the motion's dtype, on its device."""
    return torch.arange(n, dtype=motion.dtype, device=motion.device)


def _field(g_row: Tensor, g_col: Tensor, motion: Tensor, image_size: Tuple[int, int]) -> Tensor:
    """-(g_row, g_col) broadcast to ``[..., 2, H, W]``."""
    shape = motion.shape[:-1] + tuple(image_size)
    return -torch.stack([g_row.expand(shape), g_col.expand(shape)], dim=-3)


def flow_from_2d_translation(motion: Tensor, image_size: Tuple[int, int]) -> Tensor:
    """Dense ``[..., 2, H, W]`` flow of a 2-DoF translation ``[..., 2]``:
    -(tx, ty) everywhere (the 2-DoF warp advects events with +(tx, ty))."""
    h, w = image_size
    return (-motion)[..., :, None, None].expand(motion.shape[:-1] + (2, h, w))


def flow_from_similarity(motion: Tensor, image_size: Tuple[int, int]) -> Tensor:
    """Dense ``[..., 2, H, W]`` flow of a 4-DoF similarity about the image
    center, motion = (tx, ty, rot [rad/s], zoom [1/s]): events advect with
    g(p) = (tx, ty) + rot perp(p - c) + zoom (p - c), the flow is -g."""
    h, w = image_size
    rx = _grid(h, motion)[:, None] - (h - 1) / 2.0  # [H, 1]
    ry = _grid(w, motion)[None, :] - (w - 1) / 2.0  # [1, W]
    tx, ty, om, zm = (motion[..., i, None, None] for i in range(4))
    gx = tx - om * ry + zm * rx
    gy = ty + om * rx + zm * ry
    return _field(gx, gy, motion, image_size)


def flow_from_rotation(motion: Tensor, image_size: Tuple[int, int],
                       calib: Tuple[float, float, float, float]) -> Tensor:
    """Dense ``[..., 2, H, W]`` flow of a calibrated 3-DoF camera rotation,
    motion = (rot_x, rot_y, rot_z) [rad/s] (camera frame: x right = image
    column, y down = image row, z forward).  The pixel velocity is the
    rotational interaction matrix
        g_col = f_c [ X Y wx - (1 + X^2) wy + Y wz ]
        g_row = f_r [ (1 + Y^2) wx - X Y wy - X wz ]
    with X = (col - c_col) / f_col, Y = (row - c_row) / f_row; the flow is
    -g.  ``calib`` is ``calib_tuple``'s (f_row, f_col, c_row, c_col)."""
    h, w = image_size
    f_r, f_c, c_r, c_c = calib
    Y = (_grid(h, motion)[:, None] - c_r) / f_r  # [H, 1]
    X = (_grid(w, motion)[None, :] - c_c) / f_c  # [1, W]
    wx, wy, wz = (motion[..., i, None, None] for i in range(3))
    g_col = f_c * (X * Y * wx - (1.0 + X * X) * wy + Y * wz)
    g_row = f_r * ((1.0 + Y * Y) * wx - X * Y * wy - X * wz)
    return _field(g_row, g_col, motion, image_size)


class Warp:
    """The JAX package's ``Warp`` facade: a motion model's parameter names
    and vector size, conversions between a parameter dict and the motion
    vector, the model's dense field, and ``warp_event``'s dispatch."""

    def __init__(self, image_size: Tuple[int, int], calculate_feature: bool = False,
                 normalize_t: bool = False, calib_param=None):
        self.image_size = tuple(image_size)
        self.normalize_t = normalize_t
        self.calib_param = calib_param

    def get_key_names(self, motion_model: str):
        if motion_model in ("dense-flow", "2d-translation", "rigid-optical-flow"):
            return ["trans_x", "trans_y"]
        if motion_model == "4-param-similarity":
            return ["trans_x", "trans_y", "rot", "zoom"]
        if motion_model == "3-rotation":
            return ["rot_x", "rot_y", "rot_z"]
        raise ValueError(f"motion model {motion_model!r} not supported")

    def get_motion_vector_size(self, motion_model: str) -> int:
        return len(self.get_key_names(motion_model))

    def motion_model_to_motion(self, motion_model: str, params: dict) -> np.ndarray:
        if motion_model == "dense-flow":
            motion = torch.as_tensor([params["trans_x"], params["trans_y"]], dtype=torch.float64)
            return flow_from_2d_translation(motion, self.image_size).numpy()
        if motion_model not in ("2d-translation", "rigid-optical-flow", "4-param-similarity", "3-rotation"):
            raise ValueError(f"motion model {motion_model!r} not supported")
        return np.array([params[k] for k in self.get_key_names(motion_model)])

    def motion_model_from_motion(self, motion, motion_model: str) -> dict:
        return {k: motion[i] for i, k in enumerate(self.get_key_names(motion_model))}

    def get_flow_from_motion(self, motion: Tensor, motion_model: str) -> Tensor:
        """The model's dense ``[..., 2, H, W]`` field of ``motion`` (a
        tensor; the grids are built on its device, in its dtype)."""
        if motion_model in ("2d-translation", "rigid-optical-flow"):
            return flow_from_2d_translation(motion, self.image_size)
        if motion_model == "4-param-similarity":
            return flow_from_similarity(motion, self.image_size)
        if motion_model == "3-rotation":
            return flow_from_rotation(motion, self.image_size, calib_tuple(self.image_size, self.calib_param))
        raise ValueError(f"motion model {motion_model!r} not supported")

    def warp_event(self, events: Tensor, motion: Tensor, motion_model: str,
                   direction: Union[str, float] = "first", weights: Optional[Tensor] = None) -> Tensor:
        """The warped events of ``motion`` under ``motion_model``: a dense
        flow, a flow voxel, the 2-DoF warp, or a global model's field
        warped as a dense flow."""
        ref_time = calculate_reftime(events, direction, weights)
        if motion_model == "dense-flow":
            return warp_dense_flow(events, motion, ref_time, self.image_size, self.normalize_t, weights)
        if motion_model == "dense-flow-voxel":
            return warp_voxel_flow(events, motion, ref_time, self.image_size, self.normalize_t, weights)
        if motion_model in ("2d-translation", "rigid-optical-flow"):
            return warp_2dof(events, motion, ref_time, self.normalize_t, weights=weights)
        flow = self.get_flow_from_motion(motion, motion_model)
        return warp_dense_flow(events, flow, ref_time, self.image_size, self.normalize_t, weights)
