"""Event warping (port of ``event_based_optical_flow_tpu/ops/warp.py``,
limited to what the pyramid CMax eval path runs).

* ``warp_2dof`` — global 2-DoF translation ``x' = x + dt * tx`` (the
  per-patch init sweep).
* ``warp_dense_flow`` — per-pixel flow ``x' = x - dt * u(x, y)`` gathered at
  the clipped integer event position (the FWL metric).
* ``multi_direction_dense_warp`` — one flow gather, several reference times
  (the plain version of the objective's warps).

Events are ``[..., n, 4]`` tensors ``(x=height, y=width, t, p)``; an
optional ``[..., n]`` weight mask keeps padded rows out of the masked
time statistics.  Warped events carry ``dt`` in the time column.
"""

from typing import Optional, Sequence, Tuple, Union

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
    """(u, v) of a [2, H, W] flow at the clipped integer event positions."""
    h, w = image_size
    ix = events[..., 0].to(torch.int64).clamp(0, h - 1)
    iy = events[..., 1].to(torch.int64).clamp(0, w - 1)
    flat = flow.reshape(2, -1)
    lin = ix * w + iy
    return flat[0, lin], flat[1, lin]


def warp_dense_flow(
    events: Tensor,
    flow: Tensor,
    reference_time: Tensor,
    image_size: Tuple[int, int],
    normalize_t: bool = False,
    weights: Optional[Tensor] = None,
) -> Tensor:
    """Dense-flow warp of [n, 4] events: x' = x - dt * flow[0, x, y]."""
    dt = calculate_dt(events, reference_time, normalize_t, weights=weights)
    u, v = _gather_flow_clipped(flow, events, image_size)
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
