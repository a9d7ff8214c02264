"""Flow accuracy metrics: EPE/AEE, N-pixel outlier rates, angular error
(port of ``event_based_optical_flow_tpu/flow/metrics.py``).

Errors are computed over pixels where the GT is finite and nonzero in
*both* components, optionally intersected with the event mask; counts
are normalized per batch item.
"""

from typing import Optional

import numpy as np
import torch

Tensor = torch.Tensor

_PE_THRESHOLDS = (1, 2, 3, 5, 10, 20)


def calculate_flow_error(flow_gt: Tensor, flow_pred: Tensor, event_mask: Optional[Tensor] = None) -> dict:
    """flow_gt, flow_pred: [B, 2, H, W]; event_mask: [B, 1, H, W] or None.

    Returns {'EPE', '1PE', ..., '20PE', 'AE'} scalar tensors."""
    gt_u = flow_gt[:, 0:1]
    gt_v = flow_gt[:, 1:2]
    flow_mask = (~torch.isinf(gt_u)) & (~torch.isinf(gt_v)) & (gt_u.abs() > 0) & (gt_v.abs() > 0)
    total_mask = flow_mask if event_mask is None else (event_mask & flow_mask)
    gt_masked = torch.where(torch.isinf(flow_gt), torch.zeros_like(flow_gt), flow_gt) * total_mask
    pred_masked = flow_pred * total_mask
    n_points = total_mask.sum(dim=(1, 2, 3)).to(flow_pred.dtype) + 1e-5

    diff = gt_masked - pred_masked
    epe = torch.sqrt(torch.square(diff).sum(dim=1))  # [B, H, W]
    errors = {"EPE": (epe.sum(dim=(1, 2)) / n_points).mean()}
    for thr in _PE_THRESHOLDS:
        errors[f"{thr}PE"] = ((epe > thr).sum(dim=(1, 2)).to(epe.dtype) / n_points).mean()

    u, v = pred_masked[:, 0], pred_masked[:, 1]
    u_gt, v_gt = gt_masked[:, 0], gt_masked[:, 1]
    cosang = (1.0 + u * u_gt + v * v_gt) / (
        torch.sqrt(1 + u * u + v * v) * torch.sqrt(1 + u_gt * u_gt + v_gt * v_gt)
    )
    ae = torch.arccos(cosang.clamp(-1.0, 1.0))
    errors["AE"] = (ae.sum(dim=(1, 2)) / n_points).mean()
    return errors


def calculate_flow_error_numpy(flow_gt: np.ndarray, flow_pred: np.ndarray,
                               event_mask: Optional[np.ndarray] = None) -> dict:
    """Host convenience wrapper returning python floats (the arrays keep
    their dtypes, as the JAX package's ``jnp.asarray`` keeps them)."""
    out = calculate_flow_error(
        torch.as_tensor(np.asarray(flow_gt)),
        torch.as_tensor(np.asarray(flow_pred)),
        None if event_mask is None else torch.as_tensor(np.asarray(event_mask)),
    )
    return {k: float(v) for k, v in out.items()}
