"""event_based_optical_flow_tpu_torch — PyTorch/CUDA port of
``event_based_optical_flow_tpu`` (contrast-maximization optical flow).

The JAX package beside this one is the reference; every module here
mirrors its counterpart's file name and semantics.  The port imports
``torch`` and numpy only — never JAX, and nothing of the JAX package.

Layer map (same layout as the JAX package):
  ops/      — warp, scatter-semantics bilinear vote, blur, sobel, tile
              interpolation, and the fused warp+vote kernel (``fused_iwe``,
              CUDA source in ``csrc/``)
  costs/    — the contrast objectives of the hybrid cost and its registry
  solver/   — CMax objective, host-driven Newton-CG, per-patch init sweep,
              pyramidal tile solver
  flow/     — AEE/NPE/AE metrics, GT advection
  data/     — synthetic loader
  utils/    — config schema, checkpoint, misc
  state.py  — warm-start state conversion to and from the JAX layout
  main.py   — CLI: ``python -m event_based_optical_flow_tpu_torch.main``

Device and dtype policy: every solver object holds an explicit ``device``
and ``dtype`` (float64 on CPU for parity with the JAX package, float32 on
CUDA unless ``solver.precision`` says otherwise).  On a CUDA tensor the
fused objective runs the hand-written kernel; on a CPU tensor it runs the
kernel's plain PyTorch version.
"""

from .types import FlowPatch, pad_events

__version__ = "0.1.0"

__all__ = ["FlowPatch", "pad_events", "__version__"]
