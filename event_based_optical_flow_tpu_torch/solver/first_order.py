"""First-order optimizer loop (port of
``event_based_optical_flow_tpu/solver/optax_loop.py``): ``optimizer.n_iter``
steps at ``optimizer.lr`` (default 0.05), keeping the best iterate seen.

Each name applies the update rule the JAX package's ``_optax_factory``
gives it, with optax's defaults (``ASGD`` is optax's sgd, ``SparseAdam``
its adam), written here as functions on tensors: ``torch.optim``'s
defaults differ from optax's in several of them (adagrad's initial
accumulator, rmsprop's eps, rprop's step bounds).  ``Adam`` and
``SparseAdam`` are ``torch.optim.Adam`` with optax's betas and eps, as the
EV-FlowNet trainer takes it (``models/train.py``).

``LBFGS`` is optax's ``lbfgs(lr)`` (optax 0.2.6), the three steps it
chains: ``scale_by_lbfgs(memory_size=10, scale_init_precond=True)`` (the
two-loop recursion over the last 10 differences of iterates and
gradients, the first step's preconditioner capped at 1/|g|), the
learning rate, and ``scale_by_zoom_linesearch(max_linesearch_steps=20,
initial_guess_strategy="one")``: the interval search and zoom of Nocedal
and Wright's algorithms 3.5-3.6 with cubic, quadratic and bisection
trial points, Hager and Zhang's approximate decrease test, and optax's
fallback to the safe (decreasing) step when the search fails
(``ZoomLinesearch``, written from ``optax/_src/linesearch.py``).  Each
trial point is one evaluation of the value and gradient, as in the JAX
loop (optax's state-carried value is not reused there); the search's
conditions run on the host in float64, one read of the trial's value and
slope each.

The loop keeps its iterate, the best iterate and the best loss on the
device: a step of the other rules reads nothing back, and the best loss is
read once at the end.
"""

import math
from typing import Callable, Dict

import numpy as np
import torch

from ..utils.tracing import read

Tensor = torch.Tensor

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
ADAMW_WEIGHT_DECAY = 1e-4
RADAM_THRESHOLD = 5.0
ADAGRAD_INITIAL_ACCUMULATOR = 0.1
ADAGRAD_EPS = 1e-7
ADADELTA_RHO = 0.9
ADADELTA_EPS = 1e-6
RMSPROP_DECAY = 0.9
RMSPROP_EPS = 1e-8
RPROP_ETAS = (0.5, 1.2)  # (minus, plus)
RPROP_STEP_BOUNDS = (1e-6, 50.0)


def optax_adam(params, lr: float) -> torch.optim.Adam:
    """``torch.optim.Adam`` with optax's adam defaults."""
    return torch.optim.Adam(params, lr=lr, betas=ADAM_BETAS, eps=ADAM_EPS)


class _TorchAdam:
    """Adam through ``optax_adam`` on one flat parameter tensor."""

    def __init__(self, x0: Tensor, lr: float):
        self.param = x0.detach().clone()
        self.opt = optax_adam([self.param], lr)

    def __call__(self, x: Tensor, g: Tensor) -> Tensor:
        self.param.grad = g
        self.opt.step()
        return self.param.detach().clone()


class _Rule:
    """One optax rule on a flat tensor: ``x_next = rule(x, g)``; its state
    (moments, step count) lives in ``self.s``."""

    def __init__(self, name: str, x0: Tensor, lr: float):
        self.name, self.lr, self.t = name, lr, 0
        z = torch.zeros_like(x0)
        self.s: Dict[str, Tensor] = {
            "Adagrad": {"sum": torch.full_like(x0, ADAGRAD_INITIAL_ACCUMULATOR)},
            "Adadelta": {"e_g": z, "e_x": z},
            "RMSprop": {"nu": z},
            "Rprop": {"step": torch.full_like(x0, lr), "prev": z},
        }.get(name, {"mu": z, "nu": z})

    def __call__(self, x: Tensor, g: Tensor) -> Tensor:
        return x + getattr(self, "_" + self.name.lower())(x, g)

    # optax.sgd (also ASGD)
    def _sgd(self, x, g):
        return -self.lr * g

    _asgd = _sgd

    def _moments(self, g):
        b1, b2 = ADAM_BETAS
        self.t += 1
        self.s["mu"] = (1 - b1) * g + b1 * self.s["mu"]
        self.s["nu"] = (1 - b2) * g**2 + b2 * self.s["nu"]
        return self.s["mu"] / (1 - b1**self.t), self.s["nu"] / (1 - b2**self.t)

    # optax.adamw: scale_by_adam, add the decayed weights, scale by -lr
    def _adamw(self, x, g):
        mu_hat, nu_hat = self._moments(g)
        return -self.lr * (mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS) + ADAMW_WEIGHT_DECAY * x)

    # optax.nadam: scale_by_adam with nesterov
    def _nadam(self, x, g):
        b1 = ADAM_BETAS[0]
        _, nu_hat = self._moments(g)
        mu_hat = b1 * (self.s["mu"] / (1 - b1 ** (self.t + 1))) + (1 - b1) * (g / (1 - b1**self.t))
        return -self.lr * (mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS))

    # optax.radam: the rectified step once ro >= threshold, else the momentum
    def _radam(self, x, g):
        b2 = ADAM_BETAS[1]
        mu_hat, nu_hat = self._moments(g)
        ro_inf = 2.0 / (1.0 - b2) - 1.0
        b2t = b2**self.t
        ro = ro_inf - 2 * self.t * b2t / (1 - b2t)
        if ro >= RADAM_THRESHOLD:
            r = math.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))
            return -self.lr * (r * mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS))
        return -self.lr * mu_hat

    # optax.adamax: an infinity-norm second moment, no bias correction on it
    def _adamax(self, x, g):
        b1, b2 = ADAM_BETAS
        self.t += 1
        self.s["mu"] = (1 - b1) * g + b1 * self.s["mu"]
        self.s["nu"] = torch.maximum(torch.abs(g) + ADAM_EPS, b2 * self.s["nu"])
        return -self.lr * ((self.s["mu"] / (1 - b1**self.t)) / self.s["nu"])

    # optax.adagrad: scale_by_rss from an accumulator of 0.1
    def _adagrad(self, x, g):
        acc = self.s["sum"] = g * g + self.s["sum"]
        scale = torch.where(acc > 0, torch.rsqrt(acc + ADAGRAD_EPS), torch.zeros_like(acc))
        return -self.lr * (scale * g)

    # optax.adadelta
    def _adadelta(self, x, g):
        rho = ADADELTA_RHO
        self.s["e_g"] = (1 - rho) * g**2 + rho * self.s["e_g"]
        u = torch.sqrt(self.s["e_x"] + ADADELTA_EPS) / torch.sqrt(self.s["e_g"] + ADADELTA_EPS) * g
        self.s["e_x"] = (1 - rho) * u**2 + rho * self.s["e_x"]
        return -self.lr * u

    # optax.rmsprop: scale_by_rms (eps inside the square root), no momentum
    def _rmsprop(self, x, g):
        self.s["nu"] = (1 - RMSPROP_DECAY) * g**2 + RMSPROP_DECAY * self.s["nu"]
        return -self.lr * (torch.rsqrt(self.s["nu"] + RMSPROP_EPS) * g)

    # optax.rprop, scale_by_rprop as optax writes it: the step applied is the
    # PREVIOUS step's signed size (zero where the gradient's sign flipped)
    def _rprop(self, x, g):
        eta_minus, eta_plus = RPROP_ETAS
        sign = g * self.s["prev"]
        step = torch.where(sign == 0, self.s["step"],
                           torch.clamp(self.s["step"] * torch.where(sign > 0, torch.full_like(g, eta_plus),
                                                                       torch.full_like(g, eta_minus)),
                                       *RPROP_STEP_BOUNDS))
        prev = torch.where(sign < 0, torch.zeros_like(g), step * torch.sign(g))
        update = torch.where(sign < 0, torch.zeros_like(self.s["prev"]), self.s["prev"])
        self.s["step"], self.s["prev"] = step, prev
        return -update


FIRST_ORDER = ("Adadelta", "Adagrad", "Adam", "AdamW", "SparseAdam", "Adamax", "ASGD", "NAdam", "RAdam",
               "RMSprop", "Rprop", "SGD")


def make_rule(name: str, x0: Tensor, lr: float) -> Callable[[Tensor, Tensor], Tensor]:
    """``rule(x, g) -> x_next`` of the first-order optimizer ``name``."""
    if name not in FIRST_ORDER:
        raise NotImplementedError(f"first-order optimizer {name!r} is not supported ({', '.join(FIRST_ORDER)})")
    if name in ("Adam", "SparseAdam"):
        return _TorchAdam(x0, lr)
    return _Rule(name, x0, lr)


LBFGS_MEMORY = 10  # optax.lbfgs's memory_size
ZOOM_MAX_STEPS = 20  # its zoom line search's max_linesearch_steps
# scale_by_zoom_linesearch's defaults
ZOOM_INCREASE = 2.0
ZOOM_SLOPE_RTOL = 1e-4
ZOOM_CURV_RTOL = 0.9
ZOOM_APPROX_DEC_RTOL = 1e-6
ZOOM_INTERVAL_THRESHOLD = 1e-5

_f64 = np.float64


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """optax's ``_cubicmin``: the critical point of the cubic through (a,
    fa), (b, fb), (c, fc) with slope fpa at a (NaN when there is none)."""
    C = fpa
    db, dc = b - a, c - a
    denom = (db * dc) * (db * dc) * (db - dc)
    v0, v1 = fb - fa - C * db, fc - fa - C * dc
    A = (dc * dc * v0 + -(db * db) * v1) / denom
    B = (-(dc * (dc * dc)) * v0 + db * (db * db) * v1) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + np.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """optax's ``_quadmin``: the critical point of the quadratic through
    (a, fa), (b, fb) with slope fpa at a."""
    db = b - a
    B = (fb - fa - fpa * db) / (db * db)
    return a - fpa / (2.0 * B)


class ZoomLinesearch:
    """optax's ``zoom_linesearch`` (``tol`` 0, no maximal step) on host
    float64 scalars: ``search(value_and_slope, f0, s0)`` returns the
    accepted step size along the update direction, from the value ``f0``
    and slope ``s0`` at step 0 and ``value_and_slope(eta) -> (f, s)`` at a
    trial step (one evaluation each); ``trials`` counts them."""

    def __init__(self, max_steps: int = ZOOM_MAX_STEPS):
        self.max_steps = max_steps
        self.trials = 0

    @staticmethod
    def _decrease_error(eta, f, s, f0, s0):
        err = f - f0 - ZOOM_SLOPE_RTOL * eta * s0
        approx = np.maximum(s - (2 * ZOOM_SLOPE_RTOL - 1.0) * s0, f - f0 - ZOOM_APPROX_DEC_RTOL * np.abs(f0))
        err = np.maximum(np.minimum(approx, err), 0.0)
        return _f64(np.inf) if np.isnan(err) else err

    @staticmethod
    def _curvature_error(s, s0):
        err = np.maximum(np.abs(s) - ZOOM_CURV_RTOL * np.abs(s0), 0.0)
        return _f64(np.inf) if np.isnan(err) else err

    def search(self, value_and_slope: Callable, f0: float, s0: float) -> float:
        with np.errstate(all="ignore"):
            return float(self._search(value_and_slope, _f64(f0), _f64(s0)))

    def _search(self, value_and_slope, f0, s0):
        zero = _f64(0.0)
        count, eta, f, s = 0, zero, f0, s0
        low, f_low, s_low = zero, f0, s0
        high, f_high, s_high = zero, f0, s0
        cubic_ref, f_cubic_ref = zero, f0
        safe_eta, safe_f = zero, f0
        interval_found = done = failed = False
        dec_err = _f64(np.inf)
        while not (done or failed):
            if not interval_found:
                # interval search (Nocedal and Wright, algorithm 3.5)
                new = _f64(1.0) if count == 0 else ZOOM_INCREASE * eta
                nf, ns = (_f64(v) for v in value_and_slope(new))
                self.trials += 1
                dec_err = self._decrease_error(new, nf, ns, f0, s0)
                error = np.maximum(dec_err, self._curvature_error(ns, s0))
                if dec_err <= 0.0:
                    safe_eta, safe_f = new, nf
                set_high = bool(dec_err > 0.0) or (bool(nf >= f) and count > 0)
                set_low = bool(ns >= 0.0) and not set_high
                if set_low:
                    low, f_low, s_low, high, f_high, s_high = new, nf, ns, eta, f, s
                else:
                    low, f_low, s_low, high, f_high, s_high = eta, f, s, new, nf, ns
                interval_found = set_high or set_low or bool(error <= 0.0)
                done = bool(error <= 0.0)
                failed = count + 1 >= self.max_steps and not done
                cubic_ref, f_cubic_ref = low, f_low
            else:
                # zoom (algorithm 3.6): cubic, else quadratic, else bisection
                delta = np.abs(high - low)
                left, right = np.minimum(high, low), np.maximum(high, low)
                cubic = _cubicmin(low, f_low, s_low, high, f_high, cubic_ref, f_cubic_ref)
                quad = _quadmin(low, f_low, s_low, high, f_high)
                if left + 0.2 * delta < cubic < right - 0.2 * delta:
                    new = cubic
                elif left + 0.1 * delta < quad < right - 0.1 * delta:
                    new = quad
                else:
                    new = (low + high) / 2.0
                nf, ns = (_f64(v) for v in value_and_slope(new))
                self.trials += 1
                dec_err = self._decrease_error(new, nf, ns, f0, s0)
                error = np.maximum(dec_err, self._curvature_error(ns, s0))
                if dec_err <= 0.0 and nf < safe_f:
                    safe_eta, safe_f = new, nf
                done = bool(error <= 0.0)
                set_high_mid = bool(dec_err > 0.0) or bool(nf >= f_low)
                set_high_low = bool(ns * (high - low) >= 0.0) and not set_high_mid
                if set_high_mid or set_high_low:
                    cubic_ref, f_cubic_ref = high, f_high
                else:
                    cubic_ref, f_cubic_ref = low, f_low
                if set_high_mid:
                    high, f_high, s_high = new, nf, ns
                elif set_high_low:
                    high, f_high, s_high = low, f_low, s_low
                if not set_high_mid:
                    low, f_low, s_low = new, nf, ns
                failed = (count + 1 >= self.max_steps or (bool(delta <= ZOOM_INTERVAL_THRESHOLD)
                                                          and safe_eta > 0.0)) and not done
            count += 1
            eta, f, s = new, nf, ns
            if failed and (safe_eta > 0.0 or np.isinf(dec_err)):
                eta = safe_eta  # optax's _try_safe_step
        return eta


def _dot(a: Tensor, b: Tensor) -> Tensor:
    return torch.sum(a * b)


class _OptaxLBFGS:
    """``optax.lbfgs(lr)``'s update on one flat tensor: ``step(x, loss,
    grad, value_and_grad) -> x_next``; the memory of differences lives on
    the device, the zoom search's scalars on the host."""

    def __init__(self, x0: Tensor, lr: float, memory: int = LBFGS_MEMORY):
        self.lr, self.m, self.count = lr, memory, 0
        self.params, self.updates = torch.zeros_like(x0), torch.zeros_like(x0)
        self.dw = x0.new_zeros((memory,) + x0.shape)
        self.du = x0.new_zeros((memory,) + x0.shape)
        self.rho = x0.new_zeros((memory,))
        self.reads = 0

    def _precondition(self, x: Tensor, g: Tensor) -> Tensor:
        """``scale_by_lbfgs``: store the newest difference pair in slot
        (count - 1) mod m (zeros at count 0), then the two-loop product,
        newest pair first, scaled by gamma (1/|g| capped at 1 at count 0)."""
        m, idx = self.m, self.count % self.m
        if self.count > 0:
            dw, du = x - self.params, g - self.updates
            sy = _dot(du, dw)
            self.dw[(self.count - 1) % m], self.du[(self.count - 1) % m] = dw, du
            self.rho[(self.count - 1) % m] = torch.where(sy == 0.0, torch.zeros_like(sy), 1.0 / sy)
            den = _dot(du, du)
            gamma = torch.where(den > 0.0, sy / den, torch.ones_like(den))
        else:
            self.rho[m - 1] = 0.0
            self.dw[m - 1], self.du[m - 1] = 0.0, 0.0
            gamma = torch.clamp(1.0 / torch.sqrt(_dot(g, g)), max=1.0)
        order = [(idx + j) % m for j in range(m)]
        vec, alphas = g, {}
        for i in reversed(order):
            alphas[i] = self.rho[i] * _dot(self.dw[i], vec)
            vec = vec + -alphas[i] * self.du[i]
        vec = gamma * vec
        for i in order:
            beta = self.rho[i] * _dot(self.du[i], vec)
            vec = vec + (alphas[i] - beta) * self.dw[i]
        self.count += 1
        self.params, self.updates = x, g
        return vec

    def step(self, x: Tensor, loss: Tensor, g: Tensor, value_and_grad: Callable) -> Tensor:
        u = -self.lr * self._precondition(x, g)

        def value_and_slope(eta):
            f, gt = value_and_grad(x + float(eta) * u)
            self.reads += 1
            return read(torch.stack([f, _dot(gt, u)]), "host_opt").tolist()

        f0, s0 = read(torch.stack([loss, _dot(u, g)]), "host_opt").tolist()
        self.reads += 1
        eta = ZoomLinesearch().search(value_and_slope, f0, s0)
        return x + eta * u


def run_first_order(value_and_grad: Callable, x0: Tensor, method: str, opt_config: dict):
    """``opt_config["n_iter"]`` steps of ``method`` at ``opt_config["lr"]``
    (default 0.05) from ``x0``: ``value_and_grad(x) -> (loss, grad)``.
    Returns (the best iterate on the device, its loss as a float, the host
    reads: 1, and for ``LBFGS`` one more per step and per trial point)."""
    lr = float(opt_config.get("lr", 0.05))
    lbfgs = _OptaxLBFGS(x0.detach(), lr) if method == "LBFGS" else None
    rule = None if lbfgs else make_rule(method, x0, lr)
    x = x0.detach().clone()
    best_x, best_loss = x, torch.full((), math.inf, dtype=x.dtype, device=x.device)
    for _ in range(int(opt_config["n_iter"])):
        loss, grad = value_and_grad(x)
        improved = loss < best_loss
        best_x = torch.where(improved, x, best_x)
        best_loss = torch.where(improved, loss, best_loss)
        x = lbfgs.step(x, loss, grad, value_and_grad) if lbfgs else rule(x, grad)
    return best_x, float(read(best_loss, "host_opt")), 1 + (lbfgs.reads if lbfgs else 0)
