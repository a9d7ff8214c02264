"""Truncated Newton (Newton-CG) with a central finite-difference
Hessian-vector product (port of
``event_based_optical_flow_tpu/solver/newton_cg.py::build_newton_cg``,
``hvp_mode="fd"``).

Same algorithm, step for step: scipy's forcing sequence
``eta = min(0.5, sqrt|g|) |g|`` and negative-curvature fallback in the
inner CG; the two-sided backtracking line search; the outward
plateau-escape probe; best-iterate tracking.  The HVP differences two
gradients at ``x +- eps p`` with ``eps = 0.1 (1 + 1e-3 |x|) / |p|``
(pixel-scale steps: the CMax objective is piecewise smooth in sub-pixel
structure, and the fused kernel's backward is not itself differentiable).

The JAX package runs each loop as a ``lax.while_loop`` inside one device
program.  Here the loops are Python loops over device tensors: every loop
condition reads one boolean back to the host, a device synchronization.
``NewtonCG.syncs`` counts them (CUDA graphs can remove them later).
"""

from typing import Callable

import torch

Tensor = torch.Tensor

# finite-difference HVP step in parameter units
_FD_EPS_SCALE = 0.1


def _norm(v: Tensor) -> Tensor:
    return torch.sqrt(torch.sum(v * v))


def _dot(a: Tensor, b: Tensor) -> Tensor:
    return torch.sum(a * b)


class NewtonCG:
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
        fd_central: bool = True,
    ):
        self.value_fn = value_fn
        self.maxiter = maxiter
        self.cg_maxiter = cg_maxiter
        self.xtol = xtol
        self.gtol = gtol
        self.ls_maxiter = ls_maxiter
        self.armijo_c1 = armijo_c1
        self.fd_central = fd_central
        self.syncs = 0

    # --- host reads -----------------------------------------------------
    def _flag(self, t: Tensor) -> bool:
        self.syncs += 1
        return bool(t)

    # --- evaluations ----------------------------------------------------
    def _value(self, x, args) -> Tensor:
        with torch.no_grad():
            return self.value_fn(x, *args)

    def _value_grad(self, x, args):
        xr = x.detach().requires_grad_(True)
        with torch.enable_grad():
            f = self.value_fn(xr, *args)
            (g,) = torch.autograd.grad(f, xr)
        return f.detach(), g

    def _hvp(self, x, p, args, g0):
        p_norm = _norm(p) + 1e-12
        eps = _FD_EPS_SCALE * (1.0 + 1e-3 * _norm(x)) / p_norm
        g_plus = self._value_grad(x + eps * p, args)[1]
        if not self.fd_central:
            # one-sided difference against the iterate's gradient
            return (g_plus - g0) / eps
        g_minus = self._value_grad(x - eps * p, args)[1]
        return (g_plus - g_minus) / (2.0 * eps)

    # --- inner CG ---------------------------------------------------------
    def _cg_solve(self, x, g, args):
        """Truncated CG on H p = -g (scipy forcing sequence and
        negative-curvature handling)."""
        g_norm = _norm(g)
        eta = torch.minimum(g_norm.new_tensor(0.5), torch.sqrt(g_norm)) * g_norm
        r, d, p = g, -g, torch.zeros_like(g)
        i = 0
        go = i < self.cg_maxiter and self._flag(_norm(r) > eta)
        while go:
            hd = self._hvp(x, d, args, g)
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

    # --- line searches --------------------------------------------------
    def _line_search(self, x, f0, g, p, args):
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
            f_plus = self._value(x + alpha * p, args)
            f_minus = self._value(x - alpha * p, args)
            take_minus = f_minus < f_plus
            f_best = torch.where(take_minus, f_minus, f_plus)
            alpha = torch.where(take_minus, -alpha, alpha)
            i += 1
            if i >= self.ls_maxiter or not self._flag(f_best >= f0 - c1 * alpha.abs() * gtp_abs):
                break
        ok = f_best < f0 - c1 * alpha.abs() * gtp_abs
        return torch.where(ok, alpha, torch.zeros_like(alpha)), torch.where(ok, f_best, f0)

    def _escape_probe(self, x, f0, p, args):
        """Outward two-sided exponential search along p-hat after a failed
        backtracking search; returns a signed step (p-hat units) or 0."""
        p_hat = p / (_norm(p) + 1e-12)
        mag = 1.0
        best_a = torch.zeros_like(f0)
        best_f = f0
        for i in range(9):
            f_plus = self._value(x + mag * p_hat, args)
            f_minus = self._value(x - mag * p_hat, args)
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

    # --- outer loop -------------------------------------------------------
    def __call__(self, x0: Tensor, *args):
        x = x0.detach()
        f, g = self._value_grad(x, args)
        best_x, best_f = x, f
        k = 0
        done = False
        while not done and k < self.maxiter:
            p = self._cg_solve(x, g, args)
            alpha, f_new = self._line_search(x, f, g, p, args)
            # plateau escape: outward probe when backtracking failed OR the
            # first iteration found only a negligible decrease
            trigger = alpha == 0.0
            if k == 0:
                trigger = trigger | (f - f_new <= 1e-6 * (1.0 + f.abs()))
            if self._flag(trigger):
                a_esc, p_hat = self._escape_probe(x, f, p, args)
                use_esc = a_esc != 0.0
                alpha = torch.where(use_esc, torch.ones_like(alpha), alpha)
                step = torch.where(use_esc, a_esc * p_hat, alpha * p)
            else:
                step = alpha * p
            x_new = x + step
            f_new2, g_new = self._value_grad(x_new, args)
            improved = f_new2 < best_f
            best_x = torch.where(improved, x_new, best_x)
            best_f = torch.where(improved, f_new2, best_f)
            small_step = step.abs().sum() <= self.xtol
            small_grad = g_new.abs().amax() <= self.gtol
            done = self._flag(small_step | small_grad | (alpha == 0.0))
            x, f, g = x_new, f_new2, g_new
            k += 1
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
) -> NewtonCG:
    """Return ``solve(x0, *args) -> (x_best, f_best, n_iters)``.  Only the
    finite-difference HVP (``hvp_mode="fd"``) is ported: the analytic
    JVP/HVP kernels it would need are still to be ported."""
    if hvp_mode != "fd":
        raise NotImplementedError(f"hvp_mode {hvp_mode!r} is not ported yet (only 'fd')")
    return NewtonCG(value_fn, maxiter, cg_maxiter, xtol, gtol, ls_maxiter, armijo_c1, fd_central)
