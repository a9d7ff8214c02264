"""Time-aware flow propagation (port of
``event_based_optical_flow_tpu/flow/voxel.py``): build a ``[time_bin, 2, H,
W]`` flow voxel from the flow at t0 by advecting the field through time.

* ``upwind_step`` — one first-order upwind self-advection Euler step;
  negative dt uses the sign-flip trick.
* ``burgers_step`` — one inviscid-Burgers step: conservative flux for the
  self-advection terms plus upwind cross terms.
* ``construct_dense_flow_voxel`` — sequential +-(1/time_bin) chains from
  t0, earliest bin first (a Python loop; autograd and ``torch.func``
  differentiate through every step); direct schemes advect to each bin
  time.
* ``propagate_flow_to_voxel`` — direct advection x -> x + f dt resampled on
  the pixel grid: ``same``, ``bilinear`` (scatter-add), ``max`` (winner by
  |u| + |v|) and the host scipy ``griddata`` schemes.

The JAX package's two documented deviations from the original reference
are kept: its torch Burgers backward loop writes an extra junk slice that
the next step overwrites (net behaviour is the numpy version's, which is
what runs here), and its ``bilinear`` pairs the row fraction with the
wrong corner row (the consistent bilinear runs here).

Everything is plain differentiable PyTorch with no in-place writes, and
uses only ops with deterministic CUDA implementations: the edge-clamped
shifts are ``index_select`` gathers (whose backward is an ordered
scatter add) and the one-sided differences slices and ``torch.cat``,
never ``F.pad``.  Each step works on the stacked (u, v) field, a few
dozen small ops per step: on the card the chain is launch-bound.  ``torch.maximum`` / ``torch.minimum`` against zeros stand
for ``jnp.maximum`` / ``jnp.minimum``: both split the gradient 1/2 : 1/2
at a tie, which ``relu`` and ``clamp`` do not.
"""

from typing import Optional

import numpy as np
import torch

Tensor = torch.Tensor


def _diffs(c: Tensor, axis: int):
    """(backward, forward) one-sided differences along ``axis``, zero on
    the first and the last index respectively."""
    n = c.shape[axis]
    d = c.narrow(axis, 1, n - 1) - c.narrow(axis, 0, n - 1)
    size = list(c.shape)
    size[axis] = 1
    zero = c.new_zeros(size)
    return torch.cat([zero, d], dim=axis), torch.cat([d, zero], dim=axis)


def _pos(a: Tensor, zero: Tensor) -> Tensor:
    return torch.maximum(a, zero)


def _neg(a: Tensor, zero: Tensor) -> Tensor:
    return torch.minimum(a, zero)


def _scaled(a: Tensor, factor: float) -> Tensor:
    """``a * factor``, skipping the exact identities of factor 1 and -1 (a
    launch saved per op on the card, the same bits)."""
    if factor == 1:
        return a
    return -a if factor == -1 else a * factor


def _divided(a: Tensor, d) -> Tensor:
    return a if d == 1 else a / d


_TABLES = {}


def _shift_tables(h: int, w: int, device, dtype):
    """Gather indices into a flattened ``[2, H, W]`` field (u, v) and masks
    for the Burgers step's per-channel shifts, cached per geometry:

    * ``back`` / ``forw``: u at (i -+ 1, j), v at (i, j -+ 1), edge-clamped;
    * ``cross_back`` / ``cross_forw``: u at (i, j -+ 1), v at (i -+ 1, j),
      with ``mask_back`` / ``mask_forw`` zero where the one-sided
      difference is set to 0 (first / last index).
    """
    key = (h, w, str(device), dtype)
    if key not in _TABLES:
        i, j = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        lo_i, hi_i = np.maximum(i - 1, 0), np.minimum(i + 1, h - 1)
        lo_j, hi_j = np.maximum(j - 1, 0), np.minimum(j + 1, w - 1)

        def index(u_ij, v_ij):
            return torch.as_tensor(np.concatenate([(u_ij[0] * w + u_ij[1]).ravel(),
                                                   h * w + (v_ij[0] * w + v_ij[1]).ravel()]), device=device)

        def mask(u_ok, v_ok):
            return torch.as_tensor(np.stack([u_ok, v_ok]), dtype=dtype, device=device)

        _TABLES[key] = {
            "back": index((lo_i, j), (i, lo_j)), "forw": index((hi_i, j), (i, hi_j)),
            "cross_back": index((i, lo_j), (lo_i, j)), "cross_forw": index((i, hi_j), (hi_i, j)),
            "mask_back": mask(j > 0, i > 0), "mask_forw": mask(j < w - 1, i < h - 1),
        }
    return _TABLES[key]


def upwind_step(flow: Tensor, dt: float, dx: int = 1, dy: int = 1) -> Tensor:
    """One first-order upwind Euler step of f_t + (f . grad) f = 0."""
    if dt == 0:
        return flow
    dt_sign = 1.0 if dt > 0 else -1.0
    adt = abs(dt)
    f = _scaled(flow, dt_sign)
    u = f[..., 0:1, :, :]
    v = f[..., 1:2, :, :]
    # both channels' one-sided differences at once: [u_dx_b, v_dx_b], ...
    d_dx_b, d_dx_f = (_divided(d, dx) for d in _diffs(f, -2))
    d_dy_b, d_dy_f = (_divided(d, dy) for d in _diffs(f, -1))
    zero = f.new_zeros(())  # one 0-d zero per step, broadcast by max/min
    f_t = f - adt * (_pos(u, zero) * d_dx_b + _neg(u, zero) * d_dx_f + _pos(v, zero) * d_dy_b
                     + _neg(v, zero) * d_dy_f)
    return _scaled(f_t, dt_sign)


def burgers_step(flow: Tensor, dt: float, dx: int = 1, dy: int = 1) -> Tensor:
    """One inviscid-Burgers step: conservative (f^2 sign(f)) / 2 flux for
    the self-advection terms plus upwind cross terms.

    Written on the stacked (u, v) field: u's shifts run along H and v's
    along W (``flow_back`` / ``flow_forw``), the cross differences the
    other way, each one gather.  The JAX package's cross terms, e.g.
    ``max(u, 0) * [0, v_dx_back]  +  max(v, 0) * [u_dy_back, 0]``, are one
    product with the channel-swapped field, ``max([v, u], 0) * [u_dy_back,
    v_dx_back]``: the zero halves add nothing, so each element sums the
    same non-zero terms in the same order."""
    if dt == 0:
        return flow
    dt_sign = 1.0 if dt > 0 else -1.0
    adt = abs(dt)
    f = _scaled(flow, dt_sign)
    h, w = f.shape[-2], f.shape[-1]
    tables = _shift_tables(h, w, f.device, f.dtype)
    flat = f.reshape(f.shape[:-3] + (2 * h * w,))

    def gathered(name: str) -> Tensor:
        return flat.index_select(-1, tables[name]).reshape(f.shape)

    zero = f.new_zeros(())  # one 0-d zero per step, broadcast by max/min
    pow_flow = f**2 * torch.sign(f)
    flow_back, flow_forw = gathered("back"), gathered("forw")  # u at i-+1, v at j-+1 (edge clamp)
    d_back = -flow_back * flow_back
    d_forw = flow_forw * flow_forw
    burgers_factor = (pow_flow + _pos(torch.sign(flow_back), zero) * d_back
                      - _neg(torch.sign(flow_forw), zero) * d_forw) / 2.0

    # cross terms: u advected along W by v, v advected along H by u
    cross_back = (f - gathered("cross_back")) * tables["mask_back"]  # [u_dy_back, v_dx_back]
    cross_forw = (gathered("cross_forw") - f) * tables["mask_forw"]  # [u_dy_forw, v_dx_forw]
    if (dx, dy) != (1, 1):
        per_channel = f.new_tensor([dx, dy])[:, None, None]
        cross_back, cross_forw = cross_back / per_channel, cross_forw / per_channel
    swapped = f.flip(-3)  # [v, u]
    f_t = f - adt * (_pos(swapped, zero) * cross_back + _neg(swapped, zero) * cross_forw + burgers_factor)
    return _scaled(f_t, dt_sign)


_STEPS = {"upwind": upwind_step, "burgers": burgers_step}
# the schemes an objective runs (the host griddata schemes do not)
DEVICE_SCHEMES = ("upwind", "burgers", "same", "bilinear", "max")
HOST_SCHEMES = ("nearest", "linear", "cubic")


def t0_index(time_bin: int, t0_location: str) -> int:
    """The voxel's bin that holds the flow at t0."""
    return 0 if t0_location == "first" else time_bin // 2


def construct_dense_flow_voxel(dense_flow: Tensor, time_bin: int, scheme: str = "upwind",
                               t0_location: str = "middle", clamp: Optional[float] = None) -> Tensor:
    """``[(b,) 2, H, W]`` flow at t0 -> ``[(b,) time_bin, 2, H, W]`` voxel.
    ``upwind`` / ``burgers``: sequential +-(1/time_bin) chains from t0;
    other schemes advect directly to each bin time."""
    if t0_location not in ("first", "middle"):
        raise NotImplementedError(f"t0_location {t0_location!r} not supported")
    squeeze = dense_flow.ndim == 3
    if squeeze:
        dense_flow = dense_flow[None]
    if scheme in _STEPS:
        dt = 1.0 / time_bin
        i0 = t0_index(time_bin, t0_location)
        step = _STEPS[scheme]
        earlier, later = [], []
        f = dense_flow
        for _ in range(i0):  # earlier[k]: k + 1 steps before t0
            f = step(f, -dt)
            earlier.append(f)
        f = dense_flow
        for _ in range(time_bin - 1 - i0):
            f = step(f, dt)
            later.append(f)
        voxel = torch.stack(earlier[::-1] + [dense_flow] + later, dim=1)
    else:
        if t0_location == "first":
            times = [i / time_bin for i in range(time_bin)]
        else:
            times = [(i - time_bin // 2) / time_bin for i in range(time_bin)]
        voxel = torch.stack([propagate_flow_to_voxel(dense_flow, t, scheme) for t in times], dim=1)
    if clamp is not None:
        lo = torch.full_like(voxel, -clamp)
        voxel = torch.minimum(torch.maximum(voxel, lo), -lo)
    return voxel[0] if squeeze else voxel


def propagate_flow_to_voxel(flow_0: Tensor, dt: float, method: str = "same") -> Tensor:
    """Direct advection x -> x + f dt, resampled on the pixel grid;
    ``[(b,) 2, H, W]``."""
    if flow_0.ndim == 4:
        return torch.stack([_propagate_single(f, dt, method) for f in flow_0])
    return _propagate_single(flow_0, dt, method)


def _propagate_single(flow_0: Tensor, dt: float, method: str) -> Tensor:
    if method == "same":
        return flow_0
    _, h, w = flow_0.shape
    u = flow_0[0].reshape(-1)
    v = flow_0[1].reshape(-1)
    rows = torch.arange(h, dtype=flow_0.dtype, device=flow_0.device).repeat_interleave(w)
    cols = torch.arange(w, dtype=flow_0.dtype, device=flow_0.device).repeat(h)
    tx = u * dt + rows  # advected row position
    ty = v * dt + cols  # advected col position

    if method in ("bilinear", "max"):
        x1 = torch.floor(tx + 1e-8)
        y1 = torch.floor(ty + 1e-8)
        corners = []
        for drow, dcol in ((0, 0), (1, 0), (0, 1), (1, 1)):
            r, c = x1 + drow, y1 + dcol
            ok = (0 <= r) & (r < h) & (0 <= c) & (c < w)
            lin = torch.where(ok, r * w + c, torch.zeros_like(r)).to(torch.int64)
            corners.append((drow, dcol, lin, ok))
    if method == "bilinear":
        fx = tx - x1
        fy = ty - y1
        zero = torch.zeros_like(u)
        idx, vals_u, vals_v = [], [], []
        for drow, dcol, lin, ok in corners:
            wgt = (fx if drow else 1 - fx) * (fy if dcol else 1 - fy)
            idx.append(lin)
            vals_u.append(torch.where(ok, wgt * u, zero))
            vals_v.append(torch.where(ok, wgt * v, zero))
        idx = torch.cat(idx)
        out = [torch.zeros(h * w, dtype=flow_0.dtype, device=flow_0.device).index_put(
            (idx,), torch.cat(vals), accumulate=True) for vals in (vals_u, vals_v)]
        return torch.stack([o.reshape(h, w) for o in out])

    if method == "max":
        # winner per pixel by |u| + |v| among the 4 corner candidates
        neg_inf = torch.full_like(u, -float("inf"))
        score = u.abs() + v.abs()
        score_img = neg_inf.clone()
        for _, _, lin, ok in corners:
            score_img = score_img.scatter_reduce(0, lin, torch.where(ok, score, neg_inf), "amax")
        # the winners' max onto zeros, as the JAX package takes it (so a
        # negative winning component reads 0)
        out_u = out_v = torch.zeros_like(u)
        for _, _, lin, ok in corners:
            win = ok & (score >= score_img[lin])
            out_u = out_u.scatter_reduce(0, lin, torch.where(win, u, neg_inf), "amax")
            out_v = out_v.scatter_reduce(0, lin, torch.where(win, v, neg_inf), "amax")
        return torch.stack([out_u.reshape(h, w), out_v.reshape(h, w)])

    if method in HOST_SCHEMES:
        import scipy.interpolate

        f0 = flow_0.detach().cpu().numpy()
        pts = np.stack([tx.detach().cpu().numpy(), ty.detach().cpu().numpy()], axis=1)
        dst = np.stack([rows.cpu().numpy(), cols.cpu().numpy()], axis=1)
        out = np.stack([scipy.interpolate.griddata(pts, f0[k].reshape(-1), dst, method=method)
                        for k in range(2)])
        return torch.as_tensor(out.reshape(2, h, w), dtype=flow_0.dtype, device=flow_0.device)

    raise NotImplementedError(f"propagation method {method!r} is not supported")
