"""Solver layer of the port and its registry (same registry names as the
JAX package): the pyramidal tile solver and the single-scale tile solvers
(plain and time-aware), each with the device Newton-CG."""

from .base import SolverBase
from .newton_cg import NewtonCG, build_newton_cg
from .objective import FrameEvents, ObjectiveSpec, build_objective, build_orig_iwe
from .mixed import MixedPatchContrastMaximization
from .patch_base import PatchContrastMaximization, prepare_patch
from .pyramid import PyramidalPatchContrastMaximization
from .time_aware import TimeAwarePatchContrastMaximization

collections = {
    "mixed_patch_contrast_maximization": MixedPatchContrastMaximization,
    "pyramidal_patch_contrast_maximization": PyramidalPatchContrastMaximization,
    "time_aware_mixed_patch_contrast_maximization": TimeAwarePatchContrastMaximization,
}

# optimizer.method values the port runs (the device Newton-CG)
OPTIMIZERS = ("Newton-CG",)

__all__ = [
    "SolverBase",
    "PatchContrastMaximization",
    "MixedPatchContrastMaximization",
    "PyramidalPatchContrastMaximization",
    "TimeAwarePatchContrastMaximization",
    "NewtonCG",
    "build_newton_cg",
    "FrameEvents",
    "ObjectiveSpec",
    "build_objective",
    "build_orig_iwe",
    "prepare_patch",
    "collections",
    "OPTIMIZERS",
]
