"""Truncated Newton (Newton-CG) and L-BFGS (port of
``event_based_optical_flow_tpu/solver/newton_cg.py``: ``build_newton_cg``,
``build_lbfgs`` and the line searches they share, ``LineSearches``).

Same algorithm, step for step: scipy's forcing sequence
``eta = min(0.5, sqrt|g|) |g|`` and negative-curvature fallback in the
inner CG; the two-sided backtracking line search; the outward
plateau-escape probe; best-iterate tracking.  Hessian-vector products:

* ``hvp_mode="fd"``: the difference of two gradients at ``x +- eps p`` with
  ``eps = 0.1 (1 + 1e-3 |x|) / |p|`` (pixel-scale steps: the CMax
  objective is piecewise smooth in sub-pixel structure, and the fused
  kernel's backward is not itself differentiable); one-sided against the
  iterate's gradient with ``fd_central=False``;
* ``hvp_mode="analytic"``: ``hvp_fn`` supplied by the caller (the CMax
  objective's analytic Gauss-Newton HVP through the JVP and HVP-backward
  kernels), staged when ``hvp_prep_fn`` is given: ``aux = hvp_prep_fn(x,
  *args)`` once per CG solve, then ``hvp_fn(aux, x, p, *args)``.  The a.e.
  curvature misses the washboard's floor-crossing curvature, so the
  Newton direction is clipped per component to ``max_step``, and
  ``fd_polish`` central-FD iterations follow from the best iterate (no
  step clip, no escape probe), counted in the iterations.

The JAX package runs each loop as a ``lax.while_loop`` inside one device
program.  Here the loops are Python loops over device tensors: every loop
condition reads one boolean back to the host, a device synchronization.
``NewtonCG.syncs`` counts them.  The evaluations between the reads (value,
value and gradient, the HVPs) come from an evaluations object: run as
called (``EagerEvaluations``), or replayed from CUDA graphs
(``solver/graphs.py``); the arithmetic between them is the same either way.
``LBFGS`` (``optimizer.device_solver: lbfgs``) takes the same evaluations
object and needs its ``value`` and ``value_grad`` only.
"""

from typing import Callable, Optional

import torch

Tensor = torch.Tensor

# finite-difference HVP step in parameter units
_FD_EPS_SCALE = 0.1


def _norm(v: Tensor) -> Tensor:
    return torch.sqrt(torch.sum(v * v))


def _dot(a: Tensor, b: Tensor) -> Tensor:
    return torch.sum(a * b)


def fd_hvp(value_grad: Callable, x: Tensor, p: Tensor, g0: Tensor, central: bool) -> Tensor:
    """The finite-difference HVP along ``p``: the difference of the
    gradients at ``x +- eps p`` (central), or at ``x + eps p`` against the
    iterate's ``g0``; ``eps`` from ``|x|`` and ``|p|`` on the device."""
    p_norm = _norm(p) + 1e-12
    eps = _FD_EPS_SCALE * (1.0 + 1e-3 * _norm(x)) / p_norm
    g_plus = value_grad(x + eps * p)[1]
    if not central:
        return (g_plus - g0) / eps
    g_minus = value_grad(x - eps * p)[1]
    return (g_plus - g_minus) / (2.0 * eps)


class EagerEvaluations:
    """The evaluations of one Newton problem, ``value_fn(x, *args)`` (with
    the analytic HVP's ``hvp_fn`` and, staged, ``hvp_prep_fn``), run as
    they are called."""

    def __init__(self, value_fn: Callable, args: tuple, hvp_fn: Optional[Callable] = None,
                 hvp_prep_fn: Optional[Callable] = None):
        self.value_fn, self.args = value_fn, args
        self.hvp_fn, self.hvp_prep_fn = hvp_fn, hvp_prep_fn
        self.staged = hvp_prep_fn is not None

    def value(self, x: Tensor) -> Tensor:
        with torch.no_grad():
            return self.value_fn(x, *self.args)

    def value_grad(self, x: Tensor):
        xr = x.detach().requires_grad_(True)
        with torch.enable_grad():
            f = self.value_fn(xr, *self.args)
            (g,) = torch.autograd.grad(f, xr)
        return f.detach(), g

    def fd_hvp(self, x: Tensor, p: Tensor, g0: Tensor, central: bool) -> Tensor:
        return fd_hvp(self.value_grad, x, p, g0, central)

    def prep(self, x: Tensor) -> Tensor:
        return self.hvp_prep_fn(x, *self.args)

    def hvp(self, aux, x: Tensor, p: Tensor) -> Tensor:
        if self.staged:
            return self.hvp_fn(aux, x, p, *self.args)
        return self.hvp_fn(x, p, *self.args)


def batched_fd_hvp(value_grad: Callable, x: Tensor, p: Tensor, g0: Tensor, central: bool) -> Tensor:
    """``fd_hvp`` of B frames at once (``x``, ``p`` ``[B, M]``): each frame
    steps by its own ``eps = 0.1 (1 + 1e-3 |x_b|) / (|p_b| + 1e-12)``,
    computed on the device."""
    p_norm = torch.linalg.vector_norm(p, dim=-1, keepdim=True) + 1e-12
    eps = _FD_EPS_SCALE * (1.0 + 1e-3 * torch.linalg.vector_norm(x, dim=-1, keepdim=True)) / p_norm
    g_plus = value_grad(x + eps * p)[1]
    if not central:
        return (g_plus - g0) / eps
    g_minus = value_grad(x - eps * p)[1]
    return (g_plus - g_minus) / (2.0 * eps)


class BatchedEvaluations(EagerEvaluations):
    """``EagerEvaluations`` of a lockstep batch: ``value_fn(x [B, M],
    *args) -> [B]`` per-frame losses; ``value_grad`` returns them with the
    gradient of their sum (the per-frame gradients: frames are
    independent), ``fd_hvp`` steps each frame by its own ``eps``."""

    def value_grad(self, x: Tensor):
        xr = x.detach().requires_grad_(True)
        with torch.enable_grad():
            f = self.value_fn(xr, *self.args)
            (g,) = torch.autograd.grad(f.sum(), xr)
        return f.detach(), g

    def fd_hvp(self, x: Tensor, p: Tensor, g0: Tensor, central: bool) -> Tensor:
        return batched_fd_hvp(self.value_grad, x, p, g0, central)


class LineSearches:
    """The line searches the device solvers share (the JAX package's module
    functions ``_line_search`` and ``_escape_probe``), with the host-read
    count: a subclass sets ``ls_maxiter``, ``armijo_c1`` and ``syncs``."""

    ls_maxiter: int
    armijo_c1: float
    syncs: int

    def _flag(self, t: Tensor) -> bool:
        self.syncs += 1
        return bool(t)

    def _line_search(self, x, f0, g, p, ev):
        """Two-sided backtracking: at each level try x +- alpha p and accept
        the first strict improvement (largest such alpha)."""
        c1 = self.armijo_c1
        gtp_abs = _dot(g, p).abs()
        alpha = torch.ones_like(f0)
        f_best = torch.full_like(f0, float("inf"))
        i = 0
        while True:
            alpha = alpha.abs()
            if i > 0:
                alpha = alpha * 0.5
            f_plus = ev.value(x + alpha * p)
            f_minus = ev.value(x - alpha * p)
            take_minus = f_minus < f_plus
            f_best = torch.where(take_minus, f_minus, f_plus)
            alpha = torch.where(take_minus, -alpha, alpha)
            i += 1
            if i >= self.ls_maxiter or not self._flag(f_best >= f0 - c1 * alpha.abs() * gtp_abs):
                break
        ok = f_best < f0 - c1 * alpha.abs() * gtp_abs
        return torch.where(ok, alpha, torch.zeros_like(alpha)), torch.where(ok, f_best, f0)

    def _escape_probe(self, x, f0, p, ev):
        """Outward two-sided exponential search along p-hat after a failed
        backtracking search; returns a signed step (p-hat units) or 0."""
        p_hat = p / (_norm(p) + 1e-12)
        mag = 1.0
        best_a = torch.zeros_like(f0)
        best_f = f0
        for i in range(9):
            f_plus = ev.value(x + mag * p_hat)
            f_minus = ev.value(x - mag * p_hat)
            take_minus = f_minus < f_plus
            f_cand = torch.where(take_minus, f_minus, f_plus)
            a_cand = torch.where(take_minus, -torch.full_like(f0, mag), torch.full_like(f0, mag))
            better = f_cand < best_f
            best_a = torch.where(better, a_cand, best_a)
            best_f = torch.where(better, f_cand, best_f)
            mag *= 2.0
            if i == 8 or not self._flag(best_f >= f0):
                break
        ok = best_f < f0
        return torch.where(ok, best_a, torch.zeros_like(best_a)), p_hat


class NewtonCG(LineSearches):
    """``solve(x0, *args) -> (x_best, f_best, n_iters)`` for a scalar
    ``value_fn(x, *args)`` differentiable by autograd."""

    def __init__(
        self,
        value_fn: Callable,
        maxiter: int = 25,
        cg_maxiter: int = 20,
        xtol: float = 1e-5,
        gtol: float = 1e-5,
        ls_maxiter: int = 16,
        armijo_c1: float = 1e-4,
        hvp_mode: str = "fd",
        fd_central: bool = True,
        hvp_fn: Optional[Callable] = None,
        hvp_prep_fn: Optional[Callable] = None,
        max_step: Optional[float] = None,
        fd_polish: int = 0,
    ):
        self.value_fn = value_fn
        self.maxiter = maxiter
        self.cg_maxiter = cg_maxiter
        self.xtol = xtol
        self.gtol = gtol
        self.ls_maxiter = ls_maxiter
        self.armijo_c1 = armijo_c1
        self.hvp_mode = hvp_mode
        self.fd_central = fd_central
        self.hvp_fn = hvp_fn
        self.hvp_prep_fn = hvp_prep_fn
        self.max_step = max_step
        self.fd_polish = fd_polish
        self.syncs = 0

    # --- evaluations ----------------------------------------------------
    def _hvp(self, x, p, ev, g0, aux, mode):
        if mode == "analytic":
            return ev.hvp(aux, x, p)
        return ev.fd_hvp(x, p, g0, self.fd_central or mode == "fd-central")

    # --- inner CG ---------------------------------------------------------
    def _cg_solve(self, x, g, ev, mode):
        """Truncated CG on H p = -g (scipy forcing sequence and
        negative-curvature handling)."""
        g_norm = _norm(g)
        eta = torch.minimum(g_norm.new_tensor(0.5), torch.sqrt(g_norm)) * g_norm
        r, d, p = g, -g, torch.zeros_like(g)
        aux = None  # the staged analytic HVP's per-solve values, at the first HVP
        i = 0
        go = i < self.cg_maxiter and self._flag(_norm(r) > eta)
        while go:
            if aux is None and mode == "analytic" and ev.staged:
                aux = ev.prep(x)
            hd = self._hvp(x, d, ev, g, aux, mode)
            curv = _dot(d, hd)
            rs = _dot(r, r)
            neg_curv = curv <= 1e-16 * _dot(d, d)
            alpha = rs / torch.where(neg_curv, torch.ones_like(curv), curv)
            p_new = p + alpha * d
            r_new = r + alpha * hd
            beta = _dot(r_new, r_new) / rs
            flags = torch.stack([neg_curv, _norm(r_new) > eta])
            self.syncs += 1
            neg, more = flags.tolist()
            if neg:
                # scipy semantics: on non-positive curvature, at i == 0 take
                # the 1-D Newton step (rs/curv) d, else keep the accumulated p
                if i == 0:
                    p = (rs / torch.where(curv == 0, torch.ones_like(curv), curv)) * d
                break
            p, r, d = p_new, r_new, -r_new + beta * d
            i += 1
            go = more and i < self.cg_maxiter
        # CG produced nothing (eta met at once): steepest descent
        return torch.where(_dot(p, p) > 0, p, -g)

    # --- outer loops ------------------------------------------------------
    def _iterate(self, x, f, g, best_x, best_f, maxiter, ev, mode, cap, escape):
        """Newton iterations with one curvature model (``make_body`` of the
        JAX package): ``cap`` clips the Newton direction per component,
        ``escape`` arms the plateau-escape probe.  Returns (best_x, best_f,
        iterations)."""
        k = 0
        done = False
        while not done and k < maxiter:
            p = self._cg_solve(x, g, ev, mode)
            if cap is not None:
                # per component, not an inf-norm rescale: one tile's large
                # update must not shrink every other tile's step
                p = p.clamp(-cap, cap)
            alpha, f_new = self._line_search(x, f, g, p, ev)
            # plateau escape: outward probe when backtracking failed OR the
            # first iteration found only a negligible decrease
            trigger = alpha == 0.0
            if k == 0:
                trigger = trigger | (f - f_new <= 1e-6 * (1.0 + f.abs()))
            if escape and self._flag(trigger):
                a_esc, p_hat = self._escape_probe(x, f, p, ev)
                use_esc = a_esc != 0.0
                alpha = torch.where(use_esc, torch.ones_like(alpha), alpha)
                step = torch.where(use_esc, a_esc * p_hat, alpha * p)
            else:
                step = alpha * p
            x_new = x + step
            f_new2, g_new = ev.value_grad(x_new)
            improved = f_new2 < best_f
            best_x = torch.where(improved, x_new, best_x)
            best_f = torch.where(improved, f_new2, best_f)
            small_step = step.abs().sum() <= self.xtol
            small_grad = g_new.abs().amax() <= self.gtol
            done = self._flag(small_step | small_grad | (alpha == 0.0))
            x, f, g = x_new, f_new2, g_new
            k += 1
        return best_x, best_f, k

    def __call__(self, x0: Tensor, *args):
        return self.solve(EagerEvaluations(self.value_fn, args, self.hvp_fn, self.hvp_prep_fn), x0)

    def solve(self, ev, x0: Tensor):
        """``(x_best, f_best, n_iters)`` from ``x0``, the evaluations taken
        from ``ev`` (``EagerEvaluations`` or ``graphs.StagedEvaluations``)."""
        x = x0.detach()
        f, g = ev.value_grad(x)
        best_x, best_f, k = self._iterate(x, f, g, x, f, self.maxiter, ev, self.hvp_mode, self.max_step, True)
        if self.fd_polish > 0 and self.hvp_mode == "analytic":
            # central-FD refinement from the analytic solve's best iterate:
            # the Gauss-Newton a.e. curvature can read ~0 at warm
            # near-stationary points; no step clip, no escape probe
            fb, gb = ev.value_grad(best_x)
            best_x, best_f, k2 = self._iterate(best_x, fb, gb, best_x, fb, self.fd_polish, ev, "fd-central",
                                               None, False)
            k += k2
        return best_x, best_f, k


def build_newton_cg(
    value_fn: Callable,
    maxiter: int = 25,
    cg_maxiter: int = 20,
    xtol: float = 1e-5,
    gtol: float = 1e-5,
    ls_maxiter: int = 16,
    armijo_c1: float = 1e-4,
    hvp_mode: str = "fd",
    fd_central: bool = True,
    hvp_fn: Optional[Callable] = None,
    hvp_prep_fn: Optional[Callable] = None,
    max_step: Optional[float] = None,
    fd_polish: int = 0,
) -> NewtonCG:
    """Return ``solve(x0, *args) -> (x_best, f_best, n_iters)``.
    ``hvp_mode`` is ``"fd"`` or ``"analytic"`` (with ``hvp_fn``); the JAX
    package's ``"autodiff"`` grad-of-gradient mode serves objectives
    without fused kernels, which the port does not have."""
    if hvp_mode not in ("fd", "analytic"):
        raise ValueError(f"hvp_mode must be 'fd' or 'analytic', got {hvp_mode!r}")
    if (hvp_mode == "analytic") != (hvp_fn is not None) or (hvp_prep_fn is not None and hvp_fn is None):
        raise ValueError("hvp_fn (and hvp_prep_fn) go with hvp_mode='analytic' only")
    return NewtonCG(value_fn, maxiter, cg_maxiter, xtol, gtol, ls_maxiter, armijo_c1, hvp_mode,
                    fd_central, hvp_fn, hvp_prep_fn, max_step, fd_polish)


class LBFGS(LineSearches):
    """L-BFGS with Newton-CG's washboard machinery (port of the JAX
    package's ``build_lbfgs``, step for step): the two-sided backtracking
    search, the plateau-escape probe (on a failed search, or a negligible
    decrease at the first iteration), best-iterate tracking.  One gradient
    per iteration against Newton's 1 + 2 ``cg_maxiter`` (central FD): the
    large-event-count lever; ``maxiter`` counts L-BFGS iterations (~2-4x a
    Newton budget).

    The direction is the two-loop recursion over a ``memory``-slot circular
    (s, y) buffer, ``gamma`` from the newest pair; a pair enters only when
    ``s.y > 1e-10 (|s| |y| + 1e-30)``.  It stops on ``sum|step| <= xtol``,
    ``|g|_inf <= gtol`` or a zero step.  Each iteration's stop condition and
    pair test come back in one host read (``syncs``), so the pair count
    lives on the host and the recursion runs over the stored pairs only
    (the JAX package's masked terms add exact zeros).  ``solve(ev, x0)``
    takes ``ev``'s ``value`` and ``value_grad`` (``EagerEvaluations`` or a
    stage's ``graphs.StagedEvaluations``)."""

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

    def _direction(self, g: Tensor, S: Tensor, Y: Tensor, rho: Tensor, nk: int) -> Tensor:
        """-H g by the two-loop recursion over the stored pairs: age j = 0
        (newest) .. min(nk, m) - 1 in slot (nk - 1 - j) mod m."""
        m = self.memory
        slots = [(nk - 1 - j) % m for j in range(min(nk, m))]
        q, al = g, []
        for i in slots:
            a = rho[i] * _dot(S[i], q)
            q = q - a * Y[i]
            al.append(a)
        if nk > 0:
            s0, y0 = S[slots[0]], Y[slots[0]]
            yy = _dot(y0, y0)
            q = (_dot(s0, y0) / torch.where(yy > 0, yy, torch.ones_like(yy))) * q
        for a, i in zip(reversed(al), reversed(slots)):
            q = q + (a - rho[i] * _dot(Y[i], q)) * S[i]
        return -q

    def __call__(self, x0: Tensor, *args):
        return self.solve(EagerEvaluations(self.value_fn, args), x0)

    def solve(self, ev, x0: Tensor):
        """``(x_best, f_best, n_iters)`` from ``x0``."""
        x = x0.detach()
        f, g = ev.value_grad(x)
        best_x, best_f = x, f
        m = self.memory
        S, Y = x.new_zeros((m,) + x.shape), x.new_zeros((m,) + x.shape)
        rho = x.new_zeros((m,))
        nk = k = 0
        done = False
        while not done and k < self.maxiter:
            p = self._direction(g, S, Y, rho, nk)
            alpha, f_ls = self._line_search(x, f, g, p, ev)
            trigger = alpha == 0.0
            if k == 0:
                trigger = trigger | (f - f_ls <= 1e-6 * (1.0 + f.abs()))
            if self._flag(trigger):
                a_esc, p_hat = self._escape_probe(x, f, p, ev)
                use_esc = a_esc != 0.0
                step = torch.where(use_esc, a_esc * p_hat, alpha * p)
                alpha = torch.where(use_esc, torch.ones_like(alpha), alpha)
            else:
                step = alpha * p
            x_new = x + step
            f_new, g_new = ev.value_grad(x_new)
            improved = f_new < best_f
            best_x = torch.where(improved, x_new, best_x)
            best_f = torch.where(improved, f_new, best_f)
            y = g_new - g
            sy = _dot(step, y)
            good = sy > 1e-10 * (_norm(step) * _norm(y) + 1e-30)
            stop = (step.abs().sum() <= self.xtol) | (g_new.abs().amax() <= self.gtol) | (alpha == 0.0)
            x, f, g = x_new, f_new, g_new
            k += 1
            if k >= self.maxiter:
                break  # the budget ends the loop: no read
            flags = torch.stack([stop, good])
            self.syncs += 1
            done, take = flags.tolist()
            if take:
                slot = nk % m
                S[slot], Y[slot], rho[slot] = step, y, 1.0 / sy
                nk += 1
        return best_x, best_f, k


def build_lbfgs(value_fn: Callable, maxiter: int = 100, gtol: float = 1e-5, xtol: float = 1e-5, memory: int = 8,
                ls_maxiter: int = 16, armijo_c1: float = 1e-4) -> LBFGS:
    """Return ``solve(x0, *args) -> (x_best, f_best, n_iters)`` (the JAX
    package's ``build_lbfgs``)."""
    return LBFGS(value_fn, maxiter, gtol, xtol, memory, ls_maxiter, armijo_c1)
