"""Host ``scipy.optimize`` driving the port's device objective (port of
``event_based_optical_flow_tpu/solver/scipy_bridge.py``).

scipy's loop runs on the host and hands the objective float64 numpy
arrays; each evaluation (value and gradient, the HVP ``hessp`` asks for,
a whole Hessian) is one device computation whose result the caller reads
back once.  The option handling is the JAX package's: ``gtol`` dropped
where a method has none, Newton-CG's ``gtol`` passed as its ``xtol``,
``eps`` dropped (the gradients are exact), L-BFGS-B's ``disp: False``
dropped.
"""

import logging
from typing import Callable, Optional

import numpy as np
import scipy.optimize

logger = logging.getLogger(__name__)

SCIPY_OPTIMIZERS = [
    "Nelder-Mead",
    "Powell",
    "CG",
    "BFGS",
    "Newton-CG",
    "L-BFGS-B",
    "TNC",
    "COBYLA",
    "SLSQP",
    "trust-constr",
    "dogleg",
    "trust-ncg",
    "trust-exact",
    "trust-krylov",
]

_NEEDS_HVP = {"Newton-CG", "trust-ncg", "trust-krylov", "trust-constr"}
_NEEDS_HESS = {"dogleg", "trust-exact"}
_GRAD_FREE = {"Nelder-Mead", "Powell", "COBYLA"}
# methods whose scipy option set has no "gtol"
_NO_GTOL = {"Nelder-Mead", "Powell", "COBYLA", "SLSQP", "dogleg", "trust-exact"}
# scipy's Newton-CG takes a step tolerance ("xtol"): the configured gtol
# becomes it
_GTOL_AS_XTOL = {"Newton-CG"}


def minimize(
    value_and_grad: Callable,
    x0: np.ndarray,
    method: str = "Newton-CG",
    options: Optional[dict] = None,
    hvp: Optional[Callable] = None,
    hess: Optional[Callable] = None,
    history_cb: Optional[Callable] = None,
) -> scipy.optimize.OptimizeResult:
    """Minimize with a scipy method: ``value_and_grad(x) -> (loss, grad[,
    components])``, ``hvp(x, p) -> H p``, ``hess(x) -> H`` on float64
    numpy arrays; ``history_cb(loss, components)`` is called per objective
    evaluation."""
    options = dict(options or {})
    options.pop("eps", None)
    if method == "L-BFGS-B" and not options.get("disp", False):
        options.pop("disp", None)  # deprecated (scipy 1.18) when merely False
    if method in _NO_GTOL:
        options.pop("gtol", None)
    elif method in _GTOL_AS_XTOL and "gtol" in options:
        gtol = options.pop("gtol")
        if "xtol" not in options:
            options["xtol"] = gtol
            logger.debug("%s: mapped gtol=%g to xtol", method, gtol)
    x0 = np.asarray(x0, dtype=np.float64).reshape(-1)

    def fun(x):
        out = value_and_grad(x)
        if len(out) == 3:
            loss, grad, aux = out
        else:
            (loss, grad), aux = out, None
        loss = float(loss)
        if history_cb is not None:
            history_cb(loss, aux)
        return loss, np.asarray(grad, dtype=np.float64)

    kwargs = {}
    if method in _GRAD_FREE:
        kwargs["fun"] = lambda x: fun(x)[0]
    else:
        kwargs["fun"] = fun
        kwargs["jac"] = True
    if method in _NEEDS_HVP and hvp is not None:
        kwargs["hessp"] = lambda x, p: np.asarray(hvp(x, p), dtype=np.float64)
    if method in _NEEDS_HESS and hess is not None:
        kwargs["hess"] = lambda x: np.asarray(hess(x), dtype=np.float64)
    return scipy.optimize.minimize(x0=x0, method=method, options=options, **kwargs)
