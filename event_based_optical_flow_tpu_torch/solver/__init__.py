"""Solver layer of the port and its registry (same registry names as the
JAX package): the pyramidal tile solver, its fleet form (batches of
independent frames in one lockstep Newton-CG or L-BFGS per scale), the
single-scale tile solvers (plain and time-aware) and the global
motion-model solver, each with the device Newton-CG or L-BFGS or, from the
host, a scipy method, a first-order rule, optax's L-BFGS or the sampling
optimizer."""

from .base import SolverBase
from .first_order import FIRST_ORDER, run_first_order
from .fleet import BatchedLBFGS, BatchedNewtonCG, FleetPyramidalSolver
from .global_motion import GlobalMotionContrastMaximization
from .newton_cg import LBFGS, NewtonCG, build_lbfgs, build_newton_cg
from .objective import FleetEvents, FrameEvents, ObjectiveSpec, build_objective, build_orig_iwe
from .mixed import MixedPatchContrastMaximization
from .patch_base import PatchContrastMaximization, prepare_patch
from .pyramid import PyramidalPatchContrastMaximization
from .scipy_bridge import SCIPY_OPTIMIZERS, minimize
from .time_aware import TimeAwarePatchContrastMaximization

collections = {
    "fleet_pyramidal_patch_contrast_maximization": FleetPyramidalSolver,
    "global_contrast_maximization": GlobalMotionContrastMaximization,
    "mixed_patch_contrast_maximization": MixedPatchContrastMaximization,
    "pyramidal_patch_contrast_maximization": PyramidalPatchContrastMaximization,
    "time_aware_mixed_patch_contrast_maximization": TimeAwarePatchContrastMaximization,
}

# optimizer.method values the port runs, the JAX package's: the device
# Newton-CG (scipy's with optimizer.device: false), the scipy methods, the
# first-order rules, optax's LBFGS and the sampling optimizer
OPTIMIZERS = tuple(dict.fromkeys(["Newton-CG"] + SCIPY_OPTIMIZERS + list(FIRST_ORDER) + ["LBFGS", "optuna"]))

__all__ = [
    "SolverBase",
    "PatchContrastMaximization",
    "MixedPatchContrastMaximization",
    "PyramidalPatchContrastMaximization",
    "FleetPyramidalSolver",
    "GlobalMotionContrastMaximization",
    "TimeAwarePatchContrastMaximization",
    "NewtonCG",
    "build_newton_cg",
    "LBFGS",
    "build_lbfgs",
    "BatchedNewtonCG",
    "BatchedLBFGS",
    "FrameEvents",
    "FleetEvents",
    "ObjectiveSpec",
    "build_objective",
    "build_orig_iwe",
    "prepare_patch",
    "collections",
    "OPTIMIZERS",
    "SCIPY_OPTIMIZERS",
    "FIRST_ORDER",
    "minimize",
    "run_first_order",
]
