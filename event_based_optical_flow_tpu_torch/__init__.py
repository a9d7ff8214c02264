"""event_based_optical_flow_tpu_torch — PyTorch/CUDA port of
``event_based_optical_flow_tpu`` (contrast-maximization optical flow).

The JAX package beside this one is the reference; every module here
mirrors its counterpart's file name and semantics.  The port imports
``torch`` and numpy only — never JAX, and nothing of the JAX package.

Layer map (same layout as the JAX package):
  ops/      — warp, blur, sobel, tile interpolation, the standalone
              bilinear vote kernel (``vote``, K8) and the fused warp+vote
              kernels (``fused_iwe``, K1-K7), CUDA sources in ``csrc/``
  costs/    — the contrast objectives of the hybrid cost and its registry
  solver/   — CMax objective, host-driven Newton-CG, per-patch init sweep,
              pyramidal tile solver
  flow/     — AEE/NPE/AE metrics, GT advection
  data/     — synthetic loader
  utils/    — config schema, checkpoint, misc
  state.py  — warm-start state conversion to and from the JAX layout
  main.py   — CLI: ``python -m event_based_optical_flow_tpu_torch.main``
  streaming.py — serving: ``StreamingFlowEstimator`` (push API, warm-start
              chaining, state files in the JAX layout) and
              ``MultiStreamFlowEstimator`` (sequential or fleet batches)
  serve.py  — HTTP server: ``python -m event_based_optical_flow_tpu_torch.serve``

Device and dtype policy: every solver object holds an explicit ``device``
(``cuda`` unless the caller asks for the CPU) and ``dtype`` (float64 on CPU
for parity with the JAX package, float32 on CUDA unless
``solver.precision`` says otherwise).  On a CUDA tensor every vote runs a
hand-written kernel; on a CPU tensor it runs the kernel's plain PyTorch
version.
"""

from .streaming import MultiStreamFlowEstimator, StreamingFlowEstimator
from .types import FlowPatch, pad_events

__version__ = "0.1.0"

__all__ = ["FlowPatch", "pad_events", "StreamingFlowEstimator", "MultiStreamFlowEstimator", "__version__"]
