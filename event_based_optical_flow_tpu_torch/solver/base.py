"""Solver base: config plumbing, device/dtype policy, warm start (port of
``event_based_optical_flow_tpu/solver/base.py``).

Every solver object holds an explicit ``device`` and ``dtype``:
``solver.precision`` ("32"/"64") picks the dtype when set, otherwise
float64 on the CPU (parity with the JAX package) and float32 on CUDA.
Randomness is explicit too: a seeded numpy ``Generator`` for the cold
init (the JAX package's ``initialize_random`` draws, reproduced exactly)
and a ``torch.Generator`` on the solver's device for the init sweep.
"""

import logging
import os
from typing import Callable, Optional

import numpy as np
import torch

from ..state import from_jax

logger = logging.getLogger(__name__)


def resolve_dtype(precision, device: torch.device) -> torch.dtype:
    if precision is None:
        return torch.float64 if device.type == "cpu" else torch.float32
    return torch.float64 if str(precision) == "64" else torch.float32


class SolverBase:
    """Params:
        image_shape (tuple) ... (H, W)
        calibration_parameter, output_config (dict) ... taken for the JAX
            package's signature; no ported solver reads them yet.
        solver_config / optimizer_config (dict) ... the JAX package's
            YAML schema.
        device, dtype ... where and in what type the solve runs (dtype
            None: see resolve_dtype).
        candidates_fn ... optional init-sweep draw hook (solver/sampling.py).
    """

    def __init__(
        self,
        image_shape: tuple,
        calibration_parameter: dict = {},
        solver_config: dict = {},
        optimizer_config: dict = {},
        output_config: dict = {},
        device="cpu",
        dtype: Optional[torch.dtype] = None,
        candidates_fn: Optional[Callable] = None,
    ):
        self.image_shape = tuple(image_shape)
        self.opt_config = optimizer_config
        self.slv_config = solver_config
        self.iwe_config = solver_config["iwe"]
        self.device = torch.device(device)
        self.dtype = dtype or resolve_dtype(solver_config.get("precision"), self.device)
        self.previous_frame_best_estimation = None
        self.motion_vector_size = 2  # 2d-translation per tile
        self.seed = int(solver_config.get("seed", 0))
        self._rng = np.random.default_rng(self.seed)
        self.generator = torch.Generator(device=self.device).manual_seed(self.seed)
        self.candidates_fn = candidates_fn
        logger.info(
            f"Solver config: {solver_config}; optimizer: {optimizer_config}; "
            f"device {self.device}, dtype {self.dtype}"
        )

    def tensor(self, a) -> torch.Tensor:
        """Host array -> the solver's device and dtype."""
        return torch.as_tensor(np.asarray(a, dtype=np.float64), device=self.device).to(self.dtype)

    # --- warm start --------------------------------------------------------
    def set_previous_frame_best_estimation(self, previous_best):
        """Warm start from a per-scale motion dict (port tensors, or the
        JAX layout's numpy arrays)."""
        self.previous_frame_best_estimation = {
            int(k): (v.detach().to(self.device, self.dtype).clone() if torch.is_tensor(v)
                     else from_jax({k: v}, self.device, self.dtype)[int(k)])
            for k, v in previous_best.items()
        }

    def save_flow_error_as_text(self, out_dir: str, nth_frame: int, flow_error_dict: dict,
                                fname: str = "flow_error_per_frame.txt"):
        with open(os.path.join(out_dir, fname), "a") as f:
            f.write(f"frame {nth_frame}::" + str(flow_error_dict) + "\n")

    def optimize(self, events: np.ndarray):
        raise NotImplementedError
