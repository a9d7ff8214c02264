"""Per-patch sampling init sweep (port of
``event_based_optical_flow_tpu/solver/sampling.py``: ``gather_patch_events``
and ``build_patch_search``).

Each finer pyramid scale refines the expanded coarser motion per tile with
a batched candidate sweep: round 1 draws uniformly in the tile's search
box, round 2 draws gaussians around the round-1 best; the incumbent always
competes.  A candidate's cost is the normalized gradient magnitude of the
tile's middle-reference-time 2-DoF warp (lower = better), its IWE voted by
``iwe.method`` into the tile grown by ``solver.outer_padding`` (the JAX
package's ``_patch_cost_fn``).  All patches x
candidates of a round are scored in ONE batched scatter vote, not a loop
over patches.

Randomness is explicit: the draws come from the solver's
``torch.Generator`` (``draw_candidates``), or from an optional
``candidates_fn(n_patch, k1, k2) -> (uniform [P, k1, 2], normal [P, k2,
2])`` hook (numpy arrays or tensors; tests use it to feed the JAX
package's ``jax.random`` draws to the port, a data-sharded fleet its
parent solver's draws).
"""

import logging
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..costs.functional import gradient_magnitude, nan_to_penalty
from ..ops.iwe import create_iwe
from ..ops.warp import calculate_reftime, warp_2dof

logger = logging.getLogger(__name__)

Tensor = torch.Tensor


def gather_patch_events(
    events: np.ndarray, patches: dict, capacity: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side: crop events per tile, origin-shift, pad to ``capacity``.

    Patches with more than ``capacity`` events are evenly subsampled —
    acceptable for the statistical init search (the full-objective
    refinement still sees every event).

    The patches must be a non-overlapping row-major lattice (every pyramid
    scale's grid, ``prepare_patch``): per-event patch ids + one stable
    argsort, no scan per patch.  The JAX package's per-patch loop for
    irregular patch dicts has no caller in the port and is not ported.

    Returns (patch_events [P, C, 4], weights [P, C], counts [P]).
    """
    gathered = _gather_lattice_fast(events, patches, capacity)
    if gathered is None:
        raise ValueError("gather_patch_events takes a non-overlapping row-major patch lattice")
    return gathered


def _gather_lattice_fast(events: np.ndarray, patches: dict, capacity: int):
    """Vectorized gather for a non-overlapping row-major patch lattice
    (prepare_patch's layout — note the reference's FlowPatch rounding can
    make edge tiles narrower, so the bins come from the actual per-patch
    [min, max) bounds, not from the nominal patch size); returns None
    when the patch dict isn't such a lattice."""
    n_patch = len(patches)
    if n_patch == 0:
        return None
    x_mins = np.array([patches[i].x_min for i in range(n_patch)])
    y_mins = np.array([patches[i].y_min for i in range(n_patch)])
    x_maxs = np.array([patches[i].x_max for i in range(n_patch)])
    y_maxs = np.array([patches[i].y_max for i in range(n_patch)])
    xm = np.unique(x_mins)
    ym = np.unique(y_mins)
    nx, ny = len(xm), len(ym)
    if nx * ny != n_patch:
        return None
    # row-major layout with per-row/col consistent bounds
    if not (
        np.array_equal(x_mins, np.repeat(xm, ny))
        and np.array_equal(y_mins, np.tile(ym, nx))
    ):
        return None
    xx = x_maxs[::ny]  # one x_max per row
    yx = y_maxs[:ny]  # one y_max per column
    if not (
        np.array_equal(x_maxs, np.repeat(xx, ny))
        and np.array_equal(y_maxs, np.tile(yx, nx))
    ):
        return None
    # non-overlapping (an event belongs to at most one tile)
    if np.any(xx[:-1] > xm[1:]) or np.any(yx[:-1] > ym[1:]):
        return None
    row = np.searchsorted(xm, events[:, 0], side="right") - 1
    col = np.searchsorted(ym, events[:, 1], side="right") - 1
    ok = (row >= 0) & (col >= 0)
    row_c = np.clip(row, 0, nx - 1)
    col_c = np.clip(col, 0, ny - 1)
    ok &= (events[:, 0] < xx[row_c]) & (events[:, 1] < yx[col_c])
    pid = (row_c * ny + col_c)[ok]
    sel = events[ok].astype(np.float64, copy=True)
    sel[:, 0] -= x_mins[pid]
    sel[:, 1] -= y_mins[pid]
    order = np.argsort(pid, kind="stable")
    pid_s = pid[order]
    sel_s = sel[order]
    counts = np.bincount(pid_s, minlength=n_patch).astype(np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    out = np.zeros((n_patch, capacity, 4), dtype=np.float64)
    wgt = np.zeros((n_patch, capacity), dtype=np.float64)
    rank = np.arange(len(pid_s)) - starts[pid_s]
    fits = counts[pid_s] <= capacity
    out[pid_s[fits], rank[fits]] = sel_s[fits]
    wgt_k = np.minimum(counts, capacity)
    col = np.arange(capacity)
    wgt[col[None, :] < wgt_k[:, None]] = 1.0
    # pad rows carry the patch's min timestamp (keeps t_scale intact)
    nz = counts > 0
    t_min_acc = np.full(n_patch, np.inf)
    np.minimum.at(t_min_acc, pid_s, sel_s[:, 2])
    t_min = np.where(nz, t_min_acc, 0.0)
    pad_mask = (col[None, :] >= wgt_k[:, None]) & nz[:, None]
    out[..., 2] = np.where(pad_mask, t_min[:, None], out[..., 2])
    # oversubscribed patches: evenly subsample, exactly like the loop
    for i in np.nonzero(counts > capacity)[0]:
        seg = sel_s[starts[i] : starts[i] + counts[i]]
        idx = np.linspace(0, counts[i] - 1, capacity).astype(np.int64)
        out[i] = seg[idx]
    return out, wgt, counts


def draw_candidates(n_patch: int, k1: int, k2: int, generator: torch.Generator, dtype, device):
    """The sweep's draws from ``generator``: uniform ``[n_patch, k1, 2]``
    (the first round's candidates in the search box) and standard normal
    ``[n_patch, k2, 2]`` (the second round's, around the first's best)."""
    kw = {"dtype": dtype, "device": device}
    return (torch.rand((n_patch, k1, 2), generator=generator, **kw),
            torch.randn((n_patch, k2, 2), generator=generator, **kw))


def build_patch_search(
    patch_size: Tuple[int, int],
    n_candidates: int,
    blur_sigma: float = 1.0,
    abs_range: float = 10.0,
    rel_range: Tuple[float, float] = (0.8, 1.2),
    min_events: int = 10,
    candidates_fn: Optional[Callable] = None,
    iwe_method: str = "bilinear_vote",
    outer_padding: int = 0,
):
    """Build the per-scale init sweep.

    fn(patch_events [P,C,4], weights [P,C], counts [P], motion0 [P,2],
       generator) -> refined motion [P, 2]

    Search range per dim: [min, max] of {0.8*m0, m0-10, 1.2*m0, m0+10}.
    ``candidates_fn`` (optional) replaces the generator's draws.
    """
    k1 = max(1, n_candidates // 2)
    k2 = max(1, n_candidates - k1)
    axes = 3 if iwe_method == "polarity" else 2  # a polarity IWE's two channels

    def magnitude(events, weights):
        iwe = create_iwe(events, patch_size, blur_sigma, weight=weights, padding=outer_padding, method=iwe_method)
        return gradient_magnitude(iwe, omit_boundary=False, image_axes=axes)

    def score(cands, events, weights, t_scale, orig_mag, ref):
        """Loss of every candidate translation [P, K, 2] -> [P, K]."""
        warped = warp_2dof(events[:, None], cands * t_scale[:, None, None], ref[:, None],
                           normalize_t=True, weights=weights[:, None])
        return nan_to_penalty(orig_mag[:, None] / magnitude(warped, weights[:, None]))

    def pick(cands, losses):
        return cands[torch.arange(cands.shape[0], device=cands.device), losses.argmin(dim=1)]

    def search(patch_events, weights, counts, motion0, generator):
        n_patch = patch_events.shape[0]
        kw = {"dtype": patch_events.dtype, "device": patch_events.device}
        if candidates_fn is None:
            u1, n2 = draw_candidates(n_patch, k1, k2, generator, **kw)
        else:
            u1, n2 = (a.to(**kw) if torch.is_tensor(a) else torch.tensor(np.asarray(a), **kw)
                      for a in candidates_fn(n_patch, k1, k2))
        t = patch_events[..., 2]
        big = torch.finfo(t.dtype).max
        t_max = torch.where(weights > 0, t, t.new_tensor(-big)).amax(dim=-1)
        t_min = torch.where(weights > 0, t, t.new_tensor(big)).amin(dim=-1)
        one = torch.ones_like(t_max)
        t_scale = torch.where(counts > 0, t_max - t_min, one)
        t_scale = torch.where(t_scale > 0, t_scale, one)
        orig_mag = magnitude(patch_events, weights)
        ref = calculate_reftime(patch_events, 0.5, weights)

        lo = torch.minimum(rel_range[0] * motion0, motion0 - abs_range)
        hi = torch.maximum(rel_range[1] * motion0, motion0 + abs_range)
        cands1 = u1 * (hi - lo)[:, None] + lo[:, None]
        cands1 = torch.cat([motion0[:, None], cands1], dim=1)
        losses1 = score(cands1, patch_events, weights, t_scale, orig_mag, ref)
        best1 = pick(cands1, losses1)

        sigma = (hi - lo) / 8.0
        cands2 = best1[:, None] + n2 * sigma[:, None]
        cands2 = torch.minimum(torch.maximum(cands2, lo[:, None]), hi[:, None])
        losses2 = score(cands2, patch_events, weights, t_scale, orig_mag, ref)

        best = pick(torch.cat([cands1, cands2], dim=1), torch.cat([losses1, losses2], dim=1))
        return torch.where((counts > min_events)[:, None], best, motion0)

    return search
