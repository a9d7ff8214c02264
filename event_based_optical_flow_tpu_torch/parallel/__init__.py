"""Multi-device execution: meshes, sharded IWE accumulation, fleet solves
(port of ``event_based_optical_flow_tpu/parallel``).

One process drives a grid of ``torch.device`` s, as the JAX package's
single controller drives its mesh:

* data axis: frames (event windows) are independent when warm start is
  off, so they shard over "data" (the fleet solver runs one lockstep solve
  per data shard, ``solver/fleet.py``);
* event axis: bilinear voting is an associative sum, so one frame's events
  shard over "event" and the partial images reduce on the row's lead
  device; on the card in 64-bit fixed point, which keeps the single-device
  bits (``sharded.py``, ``solver/objective.py``).
"""

from .sharded import (
    Mesh,
    build_fleet_step,
    make_mesh,
    sharded_iwe,
    sharded_multifocal_loss,
)

__all__ = ["make_mesh", "sharded_iwe", "sharded_multifocal_loss", "build_fleet_step"]
