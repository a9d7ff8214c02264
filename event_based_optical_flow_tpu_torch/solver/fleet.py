"""Fleet solving: B independent frames through one lockstep solve per
pyramid scale (port of ``event_based_optical_flow_tpu/solver/fleet.py``:
``build_orig_iwe_banded_batched``, ``build_batched_objective_banded``,
``build_batched_objective_banded_hvp`` (staged), ``build_newton_cg_batched``
and ``FleetPyramidalSolver.optimize_batch``: its whole-fleet chain
``_optimize_batch_chain``, its warm finest-only fast path
``_optimize_batch_warm_finest`` and its per-scale loop).

One lockstep evaluation runs the batched kernels once for all B frames
(the frame index of ``ops/fused_iwe.py``) and the rest of the objective
with the frame as a batch axis (``torch.func.vmap`` of the single-frame
functions), so it launches about as many kernels as one single-frame
evaluation, and every loop condition is one host read for the whole batch.

With ``optimizer.chain`` (on by default, as in the JAX package) a batch
runs the JAX package's fleet chain: the cold starts of all B frames drawn
first, in frame order; per finer scale ONE init sweep over the B x P patch
batch (one draw per scale; every frame's patches gathered at the capacity
of the batch's largest frame), from the expanded coarser solutions; then
the scale's lockstep Newton, every evaluation replayed from the solver's
CUDA graphs (``solver/graphs.py``, a stage per event set of the batch).
A warm motion warm-starts the chain: one per-scale dict for every frame
(``shared``: ``data.warm_start: batch``, consecutive batches of one
sequence) or a list with one per frame (``per_frame``: the multi-stream
serving case), the coarsest start from it and every finer pre-sweep motion
averaged with it; with ``optimizer.warm_finest_only`` a warm batch solves
the finest scale only (``_optimize_batch_warm_finest``).

``optimizer.chain: false`` runs the JAX package's per-scale loop: each
frame's init sweep on its own (its own draw and capacity), cold starts
only (a warm motion is dropped with the JAX package's warning).  The two
draw differently, so their results differ, as in the JAX package.

A ``parallel:`` mesh shards the frames over its devices (the JAX package's
rule: data x event collapses onto "data", the batched kernels do not
event-shard a frame).  The batch pads to a multiple of the shards with
copies of its last frame (dropped from the results), and on the chain data
shard d solves its contiguous sub-batch on its own device with a solver of
its own (``_shard_solver``: this class, this configuration, no mesh), one
shard after another; the frames' results come back to the lead device.
The batch draws as the JAX package's meshed chain draws: this solver
decides the batch's warm mode once and takes the coarsest starts of the
whole padded batch from its own generator, shard d gets its slice, and
each finer scale's init sweep takes one draw at a shard's patch count,
which every shard reuses (``_ReplicatedSweeps``: the JAX chain replicates
the scale's key over "data"), at the padded batch's patch capacity.  No
collective runs, so a shard's frames are the bits of a single-device chain
of its sub-batch from the same starts and draws.  The per-scale loop is
not sharded, as in the JAX package: its padded batch solves on the lead
device.

The unfused objective's options (``solver.outer_padding``, ``iwe.method:
count`` / ``polarity``: ``objective.is_unfused``) run as in the sequential
objective, on the batched kernels: padding and the count vote are the
kernels' ``pad`` and ``count``; a polarity batch votes its 2B channels
(each frame's events twice) through one frame table
(``FleetEvents.channels``), each frame's flow read by both of its
channels; the lockstep Newton takes the exact HVP (a time-aware batch
with the voxel map's own curvature), no step clip, as the JAX package's
fleet differentiates its unfused objective twice.

``optimizer.device_solver: lbfgs`` replaces the lockstep Newton-CG by the
lockstep L-BFGS (``BatchedLBFGS``, the JAX package's
``build_lbfgs_batched``) in the chain and the loop alike.  The cold
starts keep the JAX package's rule: any ``solver.patch.initialize`` other
than ``zero`` draws the random init.
"""

import logging
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..ops import fused_iwe as fi
from ..ops.blur import gaussian_blur3
from ..utils.tracing import read, span, synced, traced
from .graphs import ChainGraphs
from .newton_cg import BatchedEvaluations, device_solve
from .objective import (FleetEvents, ObjectiveSpec, check_events, cost_of_images, flow_of, kernel_call,
                        map_curvature)
from .pyramid import COARSE_SUBSAMPLE_MIN_EVENTS, PyramidalPatchContrastMaximization, coarse_subsample
from .sampling import draw_candidates

logger = logging.getLogger(__name__)

Tensor = torch.Tensor


def _batched_flow(spec: ObjectiveSpec, motion: Tensor, fleet: FleetEvents) -> Tensor:
    """Motion ``[B, M]`` -> the kernels' flows ``[B, 2, H, W]`` (voxels
    ``[B, T, 2, H, W]`` when time-aware), each frame x its ``t_scale``."""
    check_events(spec, fleet)
    return torch.func.vmap(lambda m, ts: flow_of(spec, m, ts))(motion, fleet.t_scales)


def _to_kernels(fleet: FleetEvents, t: Tensor) -> Tensor:
    """A per-frame ``[B, ...]`` flow (or tangent flow) as the kernels take
    it: each frame's read by both its polarity channels (``[2B, ...]``)."""
    return t if fleet.channels is None else t.repeat_interleave(2, dim=0).contiguous()


def _images_of(fleet: FleetEvents, imgs: Tensor) -> Tensor:
    """The kernels' images ``[B', K, H', W']`` per frame: ``[B, K, H',
    W']``, a polarity batch's ``[B, K, 2, H', W']``."""
    if fleet.channels is None:
        return imgs
    return imgs.reshape((len(fleet), 2) + tuple(imgs.shape[1:])).transpose(1, 2)


def _images_to_kernels(fleet: FleetEvents, g: Tensor) -> Tensor:
    """``_images_of``'s inverse, for the cotangents the kernels take."""
    if fleet.channels is None:
        return g.contiguous()
    return g.transpose(1, 2).reshape((-1,) + tuple(g.shape[1:2]) + tuple(g.shape[3:])).contiguous()


def _per_frame(fleet: FleetEvents, dflows: Tensor) -> Tensor:
    """The kernels' flow gradient per frame: a polarity frame's channels
    summed (``_to_kernels``' transpose)."""
    if fleet.channels is None:
        return dflows
    return dflows.reshape((len(fleet), 2) + tuple(dflows.shape[1:])).sum(1)


def _over_frames(fn, orig: Optional[Tensor], n_args: int):
    """``vmap`` of ``fn(*args, orig)`` over the frame axis (``orig`` None:
    an objective without an orig IWE)."""
    return torch.func.vmap(fn, in_dims=(0,) * n_args + (None if orig is None else 0,))


def build_orig_iwe_batched(spec: ObjectiveSpec):
    """fn(fleet) -> the frames' motion-independent blurred orig IWEs ``[B,
    H, W]`` (the batched kernel's orig-only call), once per event set."""

    def orig_fn(fleet: FleetEvents) -> Tensor:
        with torch.no_grad():
            h, w = spec.image_shape
            zeros = fleet.x.new_zeros((len(fleet.kernel_frames.sizes), 2, h, w))
            call = dict(kernel_call(spec, fleet), bins=None)  # a dense zero flow: the orig image reads no bin
            imgs = _images_of(fleet, fi.fused_iwe(zeros, fleet.x, fleet.y, fleet.dtf, fleet.wt, (), True, **call))
            if spec.blur_sigma > 0:
                imgs = gaussian_blur3(imgs, spec.blur_sigma)
            return imgs[:, 0]

    return orig_fn


def build_batched_objective(spec: ObjectiveSpec):
    """fn(motion [B, M], orig [B, H, W], fleet) -> losses [B]: the batched
    kernel for every frame's direction images, then each frame's blur and
    cost."""
    offsets, cost_of = cost_of_images(spec)

    def loss_of(imgs, motion_flat, orig_blurred):
        return cost_of(imgs, motion_flat, orig_blurred)[0]

    def objective(motion: Tensor, orig: Optional[Tensor], fleet: FleetEvents) -> Tensor:
        flows = _to_kernels(fleet, _batched_flow(spec, motion, fleet).contiguous())
        imgs = fi.fused_iwe(flows, fleet.x, fleet.y, fleet.dtf, fleet.wt, offsets, False, **kernel_call(spec, fleet))
        return _over_frames(loss_of, orig, 2)(_images_of(fleet, imgs), motion, orig)

    return objective


def build_batched_objective_hvp_staged(spec: ObjectiveSpec, gauss_newton: bool = True):
    """``(prep, hvp)`` of the lockstep CG loop, the batched form of
    ``objective.build_objective_hvp_staged``: ``prep(motion, orig, fleet)``
    votes every frame's direction images once per CG solve; ``hvp(images,
    motion, p, orig, fleet) -> [B, M]`` runs the batched tangent kernel,
    each frame's cost jvp-of-grad, the batched HVP backward and the
    transpose of the motion -> flow map."""
    offsets, cost_of = cost_of_images(spec)
    grad_cost = torch.func.grad(lambda ii, mm, oo: cost_of(ii, mm, oo)[0], argnums=(0, 1))

    def cost_jvp(images, motion_flat, p, dimages, orig_blurred):
        (g1, _), (g2, dgm) = torch.func.jvp(
            lambda ii, mm: grad_cost(ii, mm, orig_blurred), (images, motion_flat), (dimages, p))
        return g1, g2, dgm

    def prep(motion: Tensor, orig: Optional[Tensor], fleet: FleetEvents) -> Tensor:
        with torch.no_grad():
            flows = _to_kernels(fleet, _batched_flow(spec, motion, fleet).contiguous())
            return _images_of(fleet, fi.fused_iwe(flows, fleet.x, fleet.y, fleet.dtf, fleet.wt, offsets, False,
                                                  **kernel_call(spec, fleet)))

    def hvp(images: Tensor, motion: Tensor, p: Tensor, orig: Optional[Tensor], fleet: FleetEvents) -> Tensor:
        flow_fn = lambda m: _batched_flow(spec, m, fleet)  # noqa: E731
        flows, flow_vjp = torch.func.vjp(flow_fn, motion)
        # the dense map is linear: its tangent along p is the map of p
        dflows = torch.func.jvp(flow_fn, (motion,), (p,))[1] if spec.time_aware else flow_fn(p)
        kflows, kdflows = _to_kernels(fleet, flows.contiguous()), _to_kernels(fleet, dflows.contiguous())
        ev, call = (fleet.x, fleet.y, fleet.dtf, fleet.wt), kernel_call(spec, fleet)
        dimages = _images_of(fleet, fi.fused_iwe_jvp(kflows, kdflows, *ev, offsets, False, **call))
        g1, g2, dgm = _over_frames(cost_jvp, orig, 4)(images, motion, p, dimages, orig)
        kg1 = _images_to_kernels(fleet, g1)
        dgflow = fi.fused_iwe_hvp_bwd(kflows, kdflows, kg1, _images_to_kernels(fleet, g2), *ev, offsets,
                                      not gauss_newton, **call)
        out = flow_vjp(_per_frame(fleet, dgflow))[0] + dgm
        if spec.time_aware and not gauss_newton:
            out = out + map_curvature(flow_fn, motion, p, kflows, kg1, ev, offsets, call,
                                      lambda g: _per_frame(fleet, g))
        return out

    return prep, hvp


def _rnorm(v: Tensor) -> Tensor:
    return torch.linalg.vector_norm(v, dim=-1)


def _rdot(a: Tensor, b: Tensor) -> Tensor:
    return torch.sum(a * b, dim=-1)


def _any(mask: Tensor, site: str) -> bool:
    """Whether any frame's ``mask`` holds: one host read for the batch."""
    return bool(read(mask.any(), site))


class BatchedLineSearches:
    """The lockstep line searches the fleet's solvers share (the JAX
    package's ``_batched_line_search`` and ``_batched_escape_probe``), one
    host read per condition for the whole batch: a subclass sets
    ``ls_maxiter`` and ``armijo_c1``."""

    ls_maxiter: int
    armijo_c1: float

    @traced("newton.line_search")
    def _line_search(self, x, f0, g, p, ev):
        """Per-frame two-sided backtracking in lockstep: each level tries x
        +- a p; a frame freezes at its first level that meets the Armijo
        test."""
        c1 = self.armijo_c1
        gtp_abs = _rdot(g, p).abs()
        alpha = torch.ones_like(f0)
        f_cur = torch.full_like(f0, float("inf"))
        accepted = torch.zeros_like(f0, dtype=torch.bool)
        i = 0
        while True:
            a = torch.ones_like(alpha) if i == 0 else alpha.abs() * 0.5
            f_plus = ev.value(x + a[:, None] * p)
            f_minus = ev.value(x - a[:, None] * p)
            take_minus = f_minus < f_plus
            f_cand = torch.where(take_minus, f_minus, f_plus)
            a_signed = torch.where(take_minus, -a, a)
            alpha = torch.where(accepted, alpha, a_signed)
            f_cur = torch.where(accepted, f_cur, f_cand)
            accepted = accepted | (f_cur < f0 - c1 * alpha.abs() * gtp_abs)
            i += 1
            if i >= self.ls_maxiter or not _any(~accepted, "line_search"):
                break
        zero = torch.zeros_like(alpha)
        return torch.where(accepted, alpha, zero), torch.where(accepted, f_cur, f0)

    @traced("newton.escape")
    def _escape_probe(self, x, f0, p, ev):
        """Outward two-sided exponential probe along p-hat per frame, while
        any frame has not improved; a signed step (p-hat units) or 0."""
        p_hat = p / (torch.linalg.vector_norm(p, dim=-1, keepdim=True) + 1e-12)
        mag = 1.0
        best_a = torch.zeros_like(f0)
        best_f = f0
        i = 0
        while True:
            f_plus = ev.value(x + mag * p_hat)
            f_minus = ev.value(x - mag * p_hat)
            take_minus = f_minus < f_plus
            f_cand = torch.where(take_minus, f_minus, f_plus)
            a_cand = torch.where(take_minus, torch.full_like(f0, -mag), torch.full_like(f0, mag))
            better = f_cand < best_f
            best_a = torch.where(better, a_cand, best_a)
            best_f = torch.where(better, f_cand, best_f)
            mag *= 2.0
            i += 1
            if i >= 9 or not _any(best_f >= f0, "escape"):
                break
        return torch.where(best_f < f0, best_a, torch.zeros_like(best_a)), p_hat


class BatchedNewtonCG(BatchedLineSearches):
    """Lockstep per-frame truncated Newton (``build_newton_cg_batched`` of
    the JAX package, step for step): ``solve(ev, x0 [B, M]) -> (best_x
    [B, M], best_f [B], iterations)``, the evaluations taken from ``ev``
    (``newton_cg.BatchedEvaluations`` of ``value_fn(x, *args) -> [B]``, or
    ``graphs.StagedEvaluations`` on a batch's stage); ``__call__(x0,
    *args)`` runs them eagerly.

    Per frame: the forcing sequence, CG state, negative-curvature fallback
    and ``done`` mask (frozen frames keep their state); the line search
    freezes each frame at its first accepted level; the FD HVP steps each
    frame by ``0.1 (1 + 1e-3 |x_b|) / (|d_b| + 1e-12)``.  The escape probe
    runs while ANY frame has not improved on its start, and every frame
    keeps its best over all probes, so a frame's result depends on which
    frames share its batch (the JAX package's semantics, kept).  Every loop
    condition is one host read for the whole batch (``syncs``)."""

    def __init__(self, value_fn: Callable, maxiter: int = 25, cg_maxiter: int = 32, xtol: float = 1e-5,
                 gtol: float = 1e-5, ls_maxiter: int = 16, armijo_c1: float = 1e-4, hvp_mode: str = "fd",
                 fd_central: bool = True, hvp_fn: Optional[Callable] = None,
                 hvp_prep_fn: Optional[Callable] = None, max_step: Optional[float] = None,
                 fd_polish: int = 0):
        if hvp_mode not in ("fd", "analytic"):
            raise ValueError(f"hvp_mode must be 'fd' or 'analytic', got {hvp_mode!r}")
        if (hvp_mode == "analytic") != (hvp_fn is not None) or (hvp_prep_fn is not None and hvp_fn is None):
            raise ValueError("hvp_fn (and hvp_prep_fn) go with hvp_mode='analytic' only")
        self.value_fn = value_fn
        self.maxiter = maxiter
        self.cg_maxiter = cg_maxiter
        self.xtol = xtol
        self.gtol = gtol
        self.ls_maxiter = ls_maxiter
        self.armijo_c1 = armijo_c1
        self.fd_central = fd_central
        self.hvp_fn = hvp_fn
        self.hvp_prep_fn = hvp_prep_fn
        self.max_step = max_step
        self.fd_polish = fd_polish
        self.syncs = 0

    def _hvp(self, x, d, g0, ev, aux, analytic, force_central):
        if analytic:
            return ev.hvp(aux, x, d)
        return ev.fd_hvp(x, d, g0, self.fd_central or force_central)

    @traced("newton.cg")
    def _cg_solve(self, x, g, ev, analytic, force_central):
        g_norm = _rnorm(g)
        eta = torch.minimum(g_norm.new_tensor(0.5), torch.sqrt(g_norm)) * g_norm
        # the staged analytic HVP's per-frame value images, once per CG solve
        aux = ev.prep(x) if analytic and ev.staged else None
        r, d, p = g, -g, torch.zeros_like(g)
        done = torch.zeros(g.shape[0], dtype=torch.bool, device=g.device)
        i = 0
        while i < self.cg_maxiter:
            active = ~done & (_rnorm(r) > eta)
            if not _any(active, "cg"):
                break
            hd = self._hvp(x, d, g, ev, aux, analytic, force_central)
            curv = _rdot(d, hd)
            rs = _rdot(r, r)
            neg = curv <= 1e-16 * _rdot(d, d)
            # scipy semantics: on non-positive curvature at i == 0 take the
            # 1-D Newton step (rs / curv) d, later keep the accumulated p
            p_fb = (rs / torch.where(curv == 0, torch.ones_like(curv), curv))[:, None] * d if i == 0 else p
            alpha = rs / torch.where(neg, torch.ones_like(curv), curv)
            p_new = p + alpha[:, None] * d
            r_new = r + alpha[:, None] * hd
            beta = _rdot(r_new, r_new) / torch.where(rs == 0, torch.ones_like(rs), rs)
            d_new = -r_new + beta[:, None] * d
            p_out = torch.where(neg[:, None], p_fb, p_new)
            upd = active[:, None]  # frozen frames keep their state
            r, d, p = torch.where(upd, r_new, r), torch.where(upd, d_new, d), torch.where(upd, p_out, p)
            done = done | (neg & active)
            i += 1
        # CG produced nothing (eta met at once): steepest descent
        return torch.where((_rdot(p, p) > 0)[:, None], p, -g)

    def _iterate(self, x, f, g, maxiter, ev, analytic, cap, escape, force_central):
        """Lockstep Newton iterations with one curvature model (``make_body``
        of the JAX package); returns (best_x, best_f, iterations)."""
        bx, bf = x, f
        done = torch.zeros_like(f, dtype=torch.bool)
        k = 0
        while k < maxiter and (k == 0 or _any(~done, "done")):
            p = self._cg_solve(x, g, ev, analytic, force_central)
            if cap is not None:
                # per component, not a per-frame inf-norm rescale
                p = p.clamp(-cap, cap)
            alpha, f_ls = self._line_search(x, f, g, p, ev)
            # plateau escape per frame: backtracking failed OR the first
            # iteration found only a negligible decrease; masked by ~done
            trigger = alpha == 0.0
            if k == 0:
                trigger = trigger | (f - f_ls <= 1e-6 * (1.0 + f.abs()))
            trigger = ~done & trigger
            if escape and _any(trigger, "trigger"):
                a_esc, p_hat = self._escape_probe(x, f, p, ev)
            else:
                a_esc, p_hat = torch.zeros_like(alpha), p
            use_esc = trigger & (a_esc != 0.0)
            alpha = torch.where(use_esc, torch.ones_like(alpha), alpha)
            step = torch.where(use_esc[:, None], a_esc[:, None] * p_hat, alpha[:, None] * p)
            x = torch.where(done[:, None], x, x + step)
            f, g = ev.value_grad(x)
            improved = f < bf
            bx = torch.where(improved[:, None], x, bx)
            bf = torch.where(improved, f, bf)
            small_step = step.abs().sum(dim=-1) <= self.xtol
            small_grad = g.abs().amax(dim=-1) <= self.gtol
            done = done | small_step | small_grad | (alpha == 0.0)
            k += 1
        return bx, bf, k

    def __call__(self, x0: Tensor, *args):
        return self.solve(BatchedEvaluations(self.value_fn, args, self.hvp_fn, self.hvp_prep_fn), x0)

    @device_solve
    def solve(self, ev, x0: Tensor):
        """``(best_x, best_f, iterations)`` from ``x0`` [B, M]."""
        x = x0.detach()
        f, g = ev.value_grad(x)
        analytic = self.hvp_fn is not None
        bx, bf, k = self._iterate(x, f, g, self.maxiter, ev, analytic, self.max_step, True, False)
        if self.fd_polish > 0 and analytic:
            # lockstep central-FD refinement from the best iterates: no step
            # clip, no escape probe
            fb, gb = ev.value_grad(bx)
            bx, bf, k2 = self._iterate(bx, fb, gb, self.fd_polish, ev, False, None, False, True)
            k += k2
        return bx, bf, k


def _take(A: Tensor, idx: Tensor) -> Tensor:
    """Row ``idx[b]`` of each frame's buffer: ``A`` [B, m, ...], ``idx``
    [B] -> [B, ...]."""
    index = idx.reshape((-1, 1) + (1,) * (A.dim() - 2)).expand((A.shape[0], 1) + A.shape[2:])
    return torch.gather(A, 1, index)[:, 0]


class BatchedLBFGS(BatchedLineSearches):
    """Lockstep per-frame L-BFGS (``build_lbfgs_batched`` of the JAX
    package, step for step): ``solve(ev, x0 [B, M]) -> (best_x [B, M],
    best_f [B], iterations)``, ``ev`` as ``BatchedNewtonCG`` takes it (only
    its ``value`` and ``value_grad``).  Per frame: the circular (s, y)
    buffer and its pair count (on the device: the two-loop recursion masks
    each frame's unstored slots), the curvature-safeguarded pair update,
    the escape trigger masked by ``~done``; a frozen frame steps 0 (its
    pair test fails).  Every loop condition is one host read for the whole
    batch (``syncs``)."""

    hvp_fn = None
    hvp_prep_fn = None

    def __init__(self, value_fn: Callable, maxiter: int = 100, gtol: float = 1e-5, xtol: float = 1e-5,
                 memory: int = 8, ls_maxiter: int = 16, armijo_c1: float = 1e-4):
        self.value_fn = value_fn
        self.maxiter = maxiter
        self.gtol = gtol
        self.xtol = xtol
        self.memory = int(memory)
        self.ls_maxiter = ls_maxiter
        self.armijo_c1 = armijo_c1
        self.syncs = 0

    def _direction(self, g: Tensor, S: Tensor, Y: Tensor, rho: Tensor, nk: Tensor) -> Tensor:
        """-H g per frame by the two-loop recursion: age j = 0 (newest) ..
        m - 1 in slot (nk - 1 - j) mod m, valid while nk - 1 - j >= 0."""
        m = self.memory
        zero = g.new_zeros(())
        q, al = g, []
        for j in range(m):
            age = nk - 1 - j
            idx = age % m
            a = torch.where(age >= 0, _take(rho, idx) * _rdot(_take(S, idx), q), zero)
            q = q - a[:, None] * _take(Y, idx)
            al.append(a)
        idx0 = (nk - 1) % m
        s0, y0 = _take(S, idx0), _take(Y, idx0)
        yy = _rdot(y0, y0)
        gamma = torch.where(nk > 0, _rdot(s0, y0) / torch.where(yy > 0, yy, torch.ones_like(yy)),
                            torch.ones_like(yy))
        r = gamma[:, None] * q
        for jj in range(m - 1, -1, -1):  # oldest first
            age = nk - 1 - jj
            idx = age % m
            b = _take(rho, idx) * _rdot(_take(Y, idx), r)
            r = r + torch.where(age >= 0, al[jj] - b, zero)[:, None] * _take(S, idx)
        return -r

    def __call__(self, x0: Tensor, *args):
        return self.solve(BatchedEvaluations(self.value_fn, args), x0)

    @device_solve
    def solve(self, ev, x0: Tensor):
        """``(best_x, best_f, iterations)`` from ``x0`` [B, M]."""
        x = x0.detach()
        f, g = ev.value_grad(x)
        bx, bf = x, f
        bsz, m = x.shape[0], self.memory
        S, Y = x.new_zeros((bsz, m, x.shape[1])), x.new_zeros((bsz, m, x.shape[1]))
        rho = x.new_zeros((bsz, m))
        nk = torch.zeros(bsz, dtype=torch.int64, device=x.device)
        slots = torch.arange(m, device=x.device)
        done = torch.zeros_like(f, dtype=torch.bool)
        k = 0
        while k < self.maxiter and (k == 0 or _any(~done, "done")):
            p = self._direction(g, S, Y, rho, nk)
            alpha, f_ls = self._line_search(x, f, g, p, ev)
            # ~done: a frozen frame's zero step must not fire the probe again
            trigger = alpha == 0.0
            if k == 0:
                trigger = trigger | (f - f_ls <= 1e-6 * (1.0 + f.abs()))
            trigger = ~done & trigger
            if _any(trigger, "trigger"):
                a_esc, p_hat = self._escape_probe(x, f, p, ev)
            else:
                a_esc, p_hat = torch.zeros_like(alpha), p
            use_esc = trigger & (a_esc != 0.0)
            alpha = torch.where(use_esc, torch.ones_like(alpha), alpha)
            step = torch.where(use_esc[:, None], a_esc[:, None] * p_hat, alpha[:, None] * p)
            step = torch.where(done[:, None], torch.zeros_like(step), step)
            x_new = x + step
            f_new, g_new = ev.value_grad(x_new)
            improved = f_new < bf
            bx = torch.where(improved[:, None], x_new, bx)
            bf = torch.where(improved, f_new, bf)
            # the curvature-safeguarded pair update (a frozen frame: s = 0, skipped)
            y = g_new - g
            sy = _rdot(step, y)
            good = sy > 1e-10 * (_rnorm(step) * _rnorm(y) + 1e-30)
            hot = ((slots[None, :] == (nk % m)[:, None]) & good[:, None])
            S = torch.where(hot[:, :, None], step[:, None, :], S)
            Y = torch.where(hot[:, :, None], y[:, None, :], Y)
            rho = torch.where(hot, (1.0 / torch.where(sy == 0, torch.ones_like(sy), sy))[:, None], rho)
            nk = nk + good.to(nk.dtype)
            small_step = step.abs().sum(dim=-1) <= self.xtol
            small_grad = g_new.abs().amax(dim=-1) <= self.gtol
            done = done | small_step | small_grad | (alpha == 0.0)
            x, f, g = x_new, f_new, g_new
            k += 1
        return bx, bf, k


class _ReplicatedSweeps:
    """The data shards' init-sweep draws: the JAX package's meshed fleet
    chain replicates each finer scale's sweep key over "data", so the k-th
    sweep of every shard takes the same draw (at a shard's patch count),
    made once by ``draw`` (the parent solver's).  ``restart()`` before each
    shard's chain; the object is that shard's ``candidates_fn``."""

    def __init__(self, draw: Callable):
        self._draw, self._made, self._k = draw, [], 0

    def restart(self) -> "_ReplicatedSweeps":
        self._k = 0
        return self

    def __call__(self, n_patch: int, k1: int, k2: int):
        if self._k == len(self._made):
            self._made.append(((n_patch, k1, k2), self._draw(n_patch, k1, k2)))
        shape, draw = self._made[self._k]
        if shape != (n_patch, k1, k2):
            raise ValueError(f"data shard sweep {self._k} draws {(n_patch, k1, k2)}, the first shard's {shape}")
        self._k += 1
        return draw


class FleetPyramidalSolver(PyramidalPatchContrastMaximization):
    """Pyramidal CMax over a fleet of frames (``optimize_batch``): chained
    (the JAX package's fleet chain, optionally warm) or, with
    ``optimizer.chain: false``, the per-scale loop; ``optimize`` (one frame)
    is the sequential pyramid's."""

    def _setup_parallel(self, parallel_config: dict, mesh=None):
        """The base's mesh, collapsed onto "data": every configured device
        is a frame shard (the JAX package's fleet rule, logged when the
        block asks for an event axis)."""
        from ..parallel.sharded import make_mesh

        super()._setup_parallel(parallel_config, mesh)
        self.n_data_shards = 1
        self._shard_solvers: List["FleetPyramidalSolver"] = []
        if self.mesh is not None:
            if self.n_event_shards > 1:
                logger.info("fleet solver: frames shard over ALL parallel devices (data x event collapsed onto "
                            "'data'); its batched kernels do not event-shard within a frame")
            self.n_data_shards = self.mesh.size
            self.mesh = make_mesh(self.mesh.size, data=self.mesh.size, event=1,
                                  devices=list(self.mesh.devices.reshape(-1)))
            self.n_event_shards = 1

    def _shard_solver(self, d: int) -> "FleetPyramidalSolver":
        """Data shard ``d``'s solver: this class with this configuration,
        no mesh, on the shard's device (made at its first batch).  It
        draws nothing of its own: its starts and its sweeps' draws are this
        solver's (``_optimize_batch_sharded``)."""
        while len(self._shard_solvers) <= d:
            k = len(self._shard_solvers)
            slv = {key: v for key, v in self.slv_config.items() if key != "parallel"}
            self._shard_solvers.append(type(self)(self.image_shape, self.calib_param, slv, self.opt_config,
                                                  self.out_config, device=self.mesh.event_devices(k)[0],
                                                  dtype=self.dtype))
        return self._shard_solvers[d]

    def _sweep_draw(self, n_patch: int, k1: int, k2: int):
        """One init-sweep draw: the hook's (``candidates_fn``), else this
        solver's generator's."""
        if self.candidates_fn is not None:
            return self.candidates_fn(n_patch, k1, k2)
        return draw_candidates(n_patch, k1, k2, self.generator, self.dtype, self.device)

    def _optimize_batch_sharded(self, events_list: List[np.ndarray], warm) -> List[Dict[int, Tensor]]:
        """The padded batch's chain over the data shards (the module
        docstring): the warm mode and the coarsest starts of the whole
        batch here, shard d's contiguous sub-batch solved by
        ``_shard_solver(d)`` from its slice of them, every shard's sweeps
        from one ``_ReplicatedSweeps``; the results on the lead device.
        ``last_batch_stats`` holds the shards' stats (``shards``), the
        frames' losses per scale and the host syncs summed."""
        n = self.n_data_shards
        bsz = len(events_list)
        per = bsz // n
        fast, warms, use_warm = self._chain_warms(warm, bsz)
        starts = None
        if not fast:
            self.overload_patch_configuration(self.coarsest_scale)
            starts = torch.stack([self._init_scale(self.coarsest_scale, w).reshape(-1) for w in warms])
        sweeps = _ReplicatedSweeps(self._sweep_draw)
        max_events = max(len(e) for e in events_list)
        results, shard_stats = [], []
        for d in range(n):
            sv, part = self._shard_solver(d), slice(d * per, (d + 1) * per)
            sv.candidates_fn = sweeps.restart()
            wp = [None if w is None else sv._motion_dict(w) for w in warms[part]]
            if fast:
                results.extend(sv._optimize_batch_warm_finest(events_list[part], wp))
            else:
                results.extend(sv._chain_scales(events_list[part], wp, use_warm, starts[part], max_events))
            shard_stats.append(sv.last_batch_stats)
        self.overload_patch_configuration(sv.current_scale)  # the metrics read the scale the solves ended at
        results = [{s: m.to(self.device) for s, m in r.items()} for r in results]
        scales = sorted(shard_stats[0]["loss"])
        self.last_batch_stats = {
            "shards": shard_stats, "chain": shard_stats[0]["chain"],
            "loss": {s: [v for st in shard_stats for v in st["loss"][s]] for s in scales},
            "iters": {s: [st["iters"][s] for st in shard_stats] for s in scales},
            "syncs": sum(st["syncs"] for st in shard_stats),
        }
        if fast:
            self.last_batch_stats["warm_finest"] = True
        logger.info(f"fleet batch of {bsz} frames over {n} data shards ({per} frames each)")
        return results

    def _init_scale(self, s: int, warm: Optional[Dict[int, Tensor]], *_) -> Tensor:
        """A frame's coarsest start: its ``warm`` motion, else the zero
        init for ``solver.patch.initialize: zero`` and the random one for
        every other value (the JAX package's fleet rule)."""
        if warm is not None:
            return warm[s].clone()
        return self.initialize_zeros() if self.slv_config["patch"]["initialize"] == "zero" else self.initialize_random()

    def _coarse_events_list(self, events_list: List[np.ndarray]):
        """Per-frame stride subsamples for the coarse scales, or None when
        ``optimizer.coarse_event_fraction`` is off or no scale is coarse.  A
        frame whose subsample would fall below the floor keeps its full
        events (per frame, as the sequential path degrades)."""
        frac = float(self.opt_config.get("coarse_event_fraction", 1.0))
        if frac >= 1.0 or self.patch_scales - self.coarsest_scale < 2:
            return None
        subs = [coarse_subsample(e, frac) for e in events_list]
        if all(s is None for s in subs):
            return None
        n_floor = sum(s is None for s in subs)
        if n_floor:
            logger.info(f"coarse_event_fraction: {n_floor}/{len(subs)} frames below the "
                        f"{COARSE_SUBSAMPLE_MIN_EVENTS}-event subsample floor solve their coarse scales "
                        "on all events")
        return [e if s is None else s for s, e in zip(subs, events_list)]

    @traced("solver.prep")
    def _newton_events(self, events_list: List[np.ndarray], chain: bool, coarse: bool = True) -> dict:
        """{"full": (fleet, orig IWEs, stage), "coarse": ...}: the batch's
        event sets (the coarse scales' subsample when ``coarse`` and
        configured) with their orig IWEs; chained, staged into the solver's
        CUDA graph buffers (stage None for the loop)."""
        if chain and self._graphs is None:
            self._graphs = ChainGraphs(self.device)
        self.overload_patch_configuration(self.coarsest_scale)
        orig_fn = build_orig_iwe_batched(self._current_spec())
        sets = {"full": events_list}
        subs = self._coarse_events_list(events_list) if coarse else None
        if subs is not None:
            sets["coarse"] = subs
        out = {}
        for name, evs in sets.items():
            fleet = FleetEvents.from_numpy(evs, self.device, self.dtype, self.time_bin,
                                           polarity=self.iwe_method == "polarity")
            orig = orig_fn(fleet)
            if chain:
                st = self._graphs.stage(f"fleet-{name}", fleet, orig)
                out[name] = (st.frame, st.orig, st)
            else:
                out[name] = (fleet, orig, None)
        return out

    def _run_fleet_newton(self, spec: ObjectiveSpec, x0: Tensor, fleet: FleetEvents, orig: Tensor,
                          maxiter: int, cg_maxiter=None, finest: bool = True, warm: bool = False, stage=None):
        """One lockstep solve of this scale's batched objective from ``x0``
        [B, M] (``warm``: the batch starts from warm motions): Newton-CG, or
        L-BFGS with ``optimizer.device_solver: lbfgs`` (hvp "lbfgs"); with
        ``stage`` (a batch's ``graphs.Stage`` whose buffers are ``fleet``
        and ``orig``) the evaluations are replayed from CUDA graphs on the
        card.  Returns (best_x, best_f [B], iterations, hvp)."""
        obj = build_batched_objective(spec)
        lbfgs = self._lbfgs_options(maxiter)
        if lbfgs is not None:
            solve, name = BatchedLBFGS(obj, **lbfgs), "lbfgs"
        else:
            name = self._curvature(spec, warm, finest)
            hvp_kw = {}
            if name != "fd":
                prep, hvp = build_batched_objective_hvp_staged(spec, name == "analytic-gn")
                hvp_kw = {"hvp_fn": hvp, "hvp_prep_fn": prep}
            solve = BatchedNewtonCG(obj, **self._newton_options(name, finest, maxiter, cg_maxiter), **hvp_kw)
        x0 = x0.to(self.dtype)
        if stage is None:
            best_x, best_f, n_iter = solve(x0, orig, fleet)
        else:
            ev = stage.evaluations((spec, name), solve.value_fn, solve.hvp_fn, solve.hvp_prep_fn)
            best_x, best_f, n_iter = solve.solve(ev, x0)
        return best_x, best_f, n_iter, name

    def _run_scales(self, scales, start: Callable, newton_events: dict, warm: bool, chain: bool) -> Dict[int, Tensor]:
        """Per scale: ``x0 = start(s, best)`` ([B, M]: the init sweeps), then
        the lockstep Newton on the scale's event set (the coarse subsample
        below the finest scale when configured); {scale: best [B, 2, h, w]}.
        ``last_batch_stats``: the lockstep iterations, per-frame losses, HVP
        model, per-frame event counts and kernel launches per scale, the
        host syncs and whether the batch ran chained."""
        from .. import ops

        bsz = len(newton_events["full"][0])
        mark = synced()
        stats = {"iters": {}, "loss": {}, "hvp": {}, "events": {}, "launches": {}, "chain": chain}
        best: Dict[int, Tensor] = {}
        for s in scales:
            with span("solver.scale", scale=s):
                self.overload_patch_configuration(s)
                spec = self._current_spec()
                finest = s == self.patch_scales - 1
                fleet, orig, stage = newton_events["full" if finest or "coarse" not in newton_events else "coarse"]
                before = ops.launch_counts()
                with span("solver.init"):
                    x0 = start(s, best)
                scale_mi, scale_cg = self._scale_budget(s)
                bx, bf, n_iter, hvp = self._run_fleet_newton(spec, x0, fleet, orig, scale_mi, scale_cg, finest,
                                                             warm, stage)
                best[s] = bx.reshape((bsz, self.motion_vector_size) + tuple(self.patch_image_size))
                losses = read(bf, "scale_loss").tolist()
                after = ops.launch_counts()
            stats["iters"][s], stats["loss"][s], stats["hvp"][s] = n_iter, losses, hvp
            stats["events"][s] = list(fleet.frames.sizes)
            stats["launches"][s] = {k: after[k] - before[k] for k in after}
            if not chain:
                logger.info(f"Fleet scale {s} done ({bsz} frames): {n_iter} lockstep iters ({hvp} HVP), "
                            f"losses {[round(v, 6) for v in losses]}")
        stats["syncs"] = synced() - mark
        self.last_batch_stats = stats
        return best

    @traced("eval_loop.solve")
    def optimize_batch(self, events_list: List[np.ndarray]) -> List[Dict[int, Tensor]]:
        """Solve B frames together: one per-scale motion dict per frame (on
        the solver's device).  Chained when ``_chain_ready`` (warm from
        ``previous_frame_best_estimation``: a per-scale dict for every
        frame, or a list of them, one per frame); else the per-scale loop,
        cold.  With a data mesh the batch pads to a shard multiple (a
        per-frame warm list with it) and the chain runs
        ``_optimize_batch_sharded``; the loop solves the padded batch here,
        as the JAX package's (its loop is not sharded)."""
        events_list = [np.asarray(e, dtype=np.float64) for e in events_list]
        bsz = len(events_list)
        warm = self.previous_frame_best_estimation
        pad = -(-bsz // self.n_data_shards) * self.n_data_shards - bsz
        if pad:
            events_list = events_list + [events_list[-1]] * pad
            if isinstance(warm, (list, tuple)) and len(warm) == bsz:
                warm = list(warm) + [warm[-1]] * pad
        if self._chain_ready():
            if self.n_data_shards > 1:
                return self._drop_padding(self._optimize_batch_sharded(events_list, warm), bsz)
            return self._optimize_batch_chain(events_list, warm)
        if warm is not None:
            logger.warning("fleet batch warm start is only supported on the chain path (optimizer.chain with "
                           "device Newton-CG); falling back to cold initialization for this batch")
            self.previous_frame_best_estimation = None
        if self.n_data_shards > 1:
            logger.info(f"fleet solver: the per-scale loop (optimizer.chain: false) is not sharded; its "
                        f"{len(events_list)} frames solve on {self.device}")
        newton_events = self._newton_events(events_list, chain=False)
        warms = [None] * len(events_list)
        best = self._run_scales(range(self.coarsest_scale, self.patch_scales),
                                lambda s, best: self._scale_start(events_list, s, best, warms, False),
                                newton_events, False, False)
        return self._drop_padding([self.update_coarse_from_fine({s: best[s][b] for s in best})
                                   for b in range(len(events_list))], bsz)

    def _drop_padding(self, results: list, bsz: int) -> list:
        """The first ``bsz`` frames' results, their losses in
        ``last_batch_stats`` alike (a data mesh's padding copies dropped)."""
        stats = self.last_batch_stats
        stats["loss"] = {s: v[:bsz] for s, v in stats["loss"].items()}
        return results[:bsz]

    def _scale_start(self, events_list: List[np.ndarray], s: int, best: Dict[int, Tensor], warms: list,
                     batched_sweep: bool, max_events: Optional[int] = None) -> Tensor:
        """The batch's start at scale ``s`` ([B, M]), frame ``b`` warm from
        ``warms[b]`` (or cold: None): at the coarsest scale the warm motion
        or the cold init (drawn frame by frame); else the expanded coarser
        solution (averaged with the warm one) refined by the init sweep:
        one call over the batch's patches (``batched_sweep``, the chain; at
        the patch capacity of ``max_events``, by default the batch's
        largest frame) or one per frame at its own capacity (the loop)."""
        bsz = len(events_list)
        pre = [self._presearch_motion(s, {s - 1: best[s - 1][b]} if s > self.coarsest_scale else {}, warms[b])
               for b in range(bsz)]
        if pre[0] is None:
            return torch.stack([self._init_scale(s, warms[b]).reshape(-1) for b in range(bsz)])
        if batched_sweep:
            motion0 = torch.stack([m for m, _ in pre])
            return self.initialize_guess_from_patch_search_batched(
                events_list, motion0, pre[0][1], max_events or max(len(e) for e in events_list)).reshape(bsz, -1)
        return torch.stack([self.initialize_guess_from_patch_search(e, *p).reshape(-1)
                            for e, p in zip(events_list, pre)])

    def _chain_warms(self, warm, bsz: int):
        """A chained batch's warm start, by the JAX package's predicates:
        ``(fast, warms, use_warm)``: whether the batch takes the warm
        finest-only fast path (decided here, once per batch: it counts the
        warm streak), each frame's warm dict or None, and whether the chain
        starts warm.  Warm modes: ``per_frame`` (a list with one full
        per-scale dict per frame), ``shared`` (one full per-scale dict,
        broadcast over the batch), else cold."""
        scales = list(range(self.coarsest_scale, self.patch_scales))
        if isinstance(warm, (list, tuple)) and len(warm) != bsz:
            raise ValueError(f"a per-frame warm list of {len(warm)} frames for a batch of {bsz}")
        per_frame = (isinstance(warm, (list, tuple)) and len(warm) > 0
                     and all(isinstance(w, dict) and all(s in w for s in scales) for w in warm))
        use_warm = per_frame or (isinstance(warm, dict) and all(s in warm for s in scales))
        # the fast-path gate takes the shared warmth predicate, so a stream's
        # streak cadence is the sequential surface's
        if self._warm_finest_active(self._warm_has_finest(warm, scales[-1])):
            return True, list(warm) if isinstance(warm, (list, tuple)) else [warm] * bsz, True
        return False, list(warm) if per_frame else [warm if use_warm else None] * bsz, use_warm

    def _optimize_batch_chain(self, events_list: List[np.ndarray], warm) -> List[Dict[int, Tensor]]:
        """The JAX package's fleet chain (``_optimize_batch_chain``) from
        ``warm`` (``_chain_warms``): the warm finest-only fast path, or
        ``_chain_scales``."""
        fast, warms, use_warm = self._chain_warms(warm, len(events_list))
        if fast:
            return self._optimize_batch_warm_finest(events_list, warms)
        return self._chain_scales(events_list, warms, use_warm)

    def _chain_scales(self, events_list: List[np.ndarray], warms: list, use_warm: bool,
                      starts: Optional[Tensor] = None, max_events: Optional[int] = None) -> List[Dict[int, Tensor]]:
        """The fleet chain's scales: the cold starts of all frames first
        (or ``starts`` [B, M]), one batched init sweep per finer scale
        (``initialize_guess_from_patch_search_batched``, at the capacity of
        ``max_events``), each scale's lockstep Newton from the batch's
        staged evaluations."""
        bsz = len(events_list)
        scales = list(range(self.coarsest_scale, self.patch_scales))
        newton_events = self._newton_events(events_list, chain=True)

        def start(s, best):
            if starts is not None and s == scales[0]:
                return starts.to(self.device)
            return self._scale_start(events_list, s, best, warms, True, max_events)

        best = self._run_scales(scales, start, newton_events, use_warm, True)
        losses = self.last_batch_stats["loss"][scales[-1]]
        logger.info(f"fleet chain done ({bsz} frames, {len(scales)} scales); losses {losses}")
        return [self.update_coarse_from_fine({s: best[s][b] for s in best}) for b in range(bsz)]

    def _optimize_batch_warm_finest(self, events_list: List[np.ndarray], warms: list) -> List[Dict[int, Tensor]]:
        """The fleet's warm finest-only fast path (the JAX package's
        ``_optimize_batch_warm_finest``): every frame solves the finest
        scale only, from its warm motion ``warms[b]``, on the full events,
        as one lockstep solve from the batch's staged evaluations; the
        coarse entries are the finest's ``pyramid_reduce``
        (``update_coarse_from_fine``)."""
        bsz = len(events_list)
        s_fin = self.patch_scales - 1
        newton_events = self._newton_events(events_list, chain=True, coarse=False)
        best = self._run_scales([s_fin], lambda s, best: torch.stack([w[s].reshape(-1) for w in warms]),
                                newton_events, True, True)
        self.last_batch_stats["warm_finest"] = True
        logger.info(f"fleet warm finest-only done ({bsz} frames); losses {self.last_batch_stats['loss'][s_fin]}")
        return [self.update_coarse_from_fine({s_fin: best[s_fin][b]}) for b in range(bsz)]
