"""Solver layer of the port and its registry (same registry names as the
JAX package).  Only the pyramidal tile solver with device Newton-CG is
ported so far."""

from .base import SolverBase
from .newton_cg import NewtonCG, build_newton_cg
from .objective import FrameEvents, ObjectiveSpec, build_objective, build_orig_iwe
from .patch_base import PatchContrastMaximization, prepare_patch
from .pyramid import PyramidalPatchContrastMaximization

collections = {
    "pyramidal_patch_contrast_maximization": PyramidalPatchContrastMaximization,
}

# optimizer.method values the port runs (the device Newton-CG)
OPTIMIZERS = ("Newton-CG",)

__all__ = [
    "SolverBase",
    "PatchContrastMaximization",
    "PyramidalPatchContrastMaximization",
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
