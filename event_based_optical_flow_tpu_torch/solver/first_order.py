"""First-order optimizer loop (port of
``event_based_optical_flow_tpu/solver/optax_loop.py``): ``optimizer.n_iter``
steps at ``optimizer.lr`` (default 0.05), keeping the best iterate seen.

Each name applies the update rule the JAX package's ``_optax_factory``
gives it, with optax's defaults (``ASGD`` is optax's sgd, ``SparseAdam``
its adam), written here as functions on tensors: ``torch.optim``'s
defaults differ from optax's in several of them (adagrad's initial
accumulator, rmsprop's eps, rprop's step bounds).  ``Adam`` and
``SparseAdam`` are ``torch.optim.Adam`` with optax's betas and eps, as the
EV-FlowNet trainer takes it (``models/train.py``).  ``LBFGS`` (optax's
L-BFGS with its zoom line search) is not ported.

The loop keeps its iterate, the best iterate and the best loss on the
device: a step reads nothing back, and the best loss is read once at the
end.
"""

import math
from typing import Callable, Dict

import torch

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


def run_first_order(value_and_grad: Callable, x0: Tensor, method: str, opt_config: dict):
    """``opt_config["n_iter"]`` steps of ``method`` at ``opt_config["lr"]``
    (default 0.05) from ``x0``: ``value_and_grad(x) -> (loss, grad)``.
    Returns (the best iterate on the device, its loss as a float: the
    loop's one host read)."""
    lr = float(opt_config.get("lr", 0.05))
    rule = make_rule(method, x0, lr)
    x = x0.detach().clone()
    best_x, best_loss = x, torch.full((), math.inf, dtype=x.dtype, device=x.device)
    for _ in range(int(opt_config["n_iter"])):
        loss, grad = value_and_grad(x)
        improved = loss < best_loss
        best_x = torch.where(improved, x, best_x)
        best_loss = torch.where(improved, loss, best_loss)
        x = rule(x, grad)
    return best_x, float(best_loss)
