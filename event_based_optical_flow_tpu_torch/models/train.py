"""EV-FlowNet training (port of ``event_based_optical_flow_tpu/models/train.py``):
the unsupervised contrast-maximization loss, the train step, checkpoints and
the CLI's DNN entry.

The network trains against the framework's own CMax objective (multi-focal
normalized gradient magnitude plus total variation of the predicted flow).
Every vote of the step, the voxel featurizer's and the loss's four IWEs per
item and scale, goes through ``ops.iwe.bilinear_vote``: K8 on a CUDA tensor
(forward), its analytic four-corner backward (``vote.BilinearVote``), the
plain version on a CPU tensor.  A scale's four IWEs of every item are one
call (one K8 launch), and the voxel grids of the batch are one more.

Functions take batches: losses map ``[..., 2, h, w]`` flows and ``[..., n,
4]`` events (``[..., n]`` weights) to ``[...]`` per-item losses, as the JAX
package's ``vmap`` of its per-item losses does.

``dnn.data_parallel`` (``dnn_train_step_parallel``): one process drives a
replica of the model on each data device, each replica takes its contiguous
part of the batch, the replicas' gradients and losses are averaged on the
lead device in mesh order (equal parts: the mean of the parts' means is the
batch mean, as the JAX package's ``pmean``), one optimizer step runs there,
and the parameters are copied back out.  The CLI takes it only when more
than one CUDA device is visible and the batch divides over them (the JAX
package's rule), else the single-device step, with a log line.

A checkpoint is the port's own ``torch.save`` of the model, the optimizer
and the step in ``<checkpoint_dir>/step_<n>/state.pt``; the JAX package's
orbax checkpoint there is refused, not read (carry its parameters across
with ``convert.params_from_flax``).
"""

import logging
import os
import re
import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..costs import functional as F
from ..costs.functional import nan_to_penalty
from ..ops.iwe import create_iwe
from ..ops.warp import Warp, _masked_max, _masked_min
from ..solver.first_order import optax_adam
from ..types import pad_events
from .ev_flownet import EVFlowNet, events_to_voxel_grid

logger = logging.getLogger(__name__)

Tensor = torch.Tensor

CHECKPOINT_FILE = "state.pt"
_ORBAX_MARKERS = ("_METADATA", "_CHECKPOINT_METADATA")


def _event_t_scale(events: Tensor, weights: Optional[Tensor] = None) -> Tensor:
    """Time span of a (padded) event window: the factor that converts the
    px/s flow convention into px displacement over the window."""
    t = events[..., 2]
    return _masked_max(t, weights) - _masked_min(t, weights)


def _per_item_tv(flow: Tensor) -> Tensor:
    """``costs.functional.total_variation`` of each ``[2, h, w]`` flow of
    a ``[..., 2, h, w]`` batch."""
    items = flow.reshape((-1,) + flow.shape[-3:])
    return torch.stack([F.total_variation(f, omit_boundary=True) for f in items]).reshape(flow.shape[:-3])


def unsupervised_cmax_loss(flow: Tensor, events: Tensor, image_size: Tuple[int, int],
                           weights: Optional[Tensor] = None, blur_sigma: float = 1.0,
                           tv_weight: float = 0.01) -> Tensor:
    """Multi-focal NGM contrast loss of dense ``[..., 2, H, W]`` flows on
    their event slices, plus total variation: the objective the CMax
    solvers optimize per tile, applied to a network prediction.  The four
    IWEs (orig, fwd, bwd, mid) of every item are voted in one call."""
    warper = Warp(image_size, normalize_t=True)
    scaled_flow = flow * _event_t_scale(events, weights)[..., None, None, None]
    bwd = warper.warp_event(events, scaled_flow, "dense-flow", "first", weights)
    fwd = warper.warp_event(events, scaled_flow, "dense-flow", "last", weights)
    mid = warper.warp_event(events, scaled_flow, "dense-flow", "middle", weights)
    stacked = torch.stack([events, fwd, bwd, mid], dim=-3)
    weight = 1.0 if weights is None else weights[..., None, :]
    orig_iwe, fwd_iwe, bwd_iwe, mid_iwe = create_iwe(stacked, image_size, blur_sigma, weight).unbind(-3)
    loss = F.multi_focal_normalized_gradient_magnitude(orig_iwe, fwd_iwe, bwd_iwe, mid_iwe, omit_boundary=True)
    loss = loss + tv_weight * _per_item_tv(flow)
    return nan_to_penalty(loss)


def multi_scale_cmax_loss(flows: dict, events: Tensor, image_size: Tuple[int, int],
                          weights: Optional[Tensor] = None, blur_sigma: float = 1.0,
                          tv_weight: float = 0.01) -> Tensor:
    """The CMax loss at every decoder scale (flow0 coarsest ... flow3 full
    resolution): scale k warps the events with their coordinates divided by
    2^(3-k) on a 2^(3-k)-downscaled grid; the mean over scales."""
    h, w = image_size
    total, n = 0.0, 0
    for i in range(4):
        key = f"flow{i}"
        if key not in flows:
            continue
        s = 2 ** (3 - i)
        scale_vec = torch.tensor([1.0 / s, 1.0 / s, 1.0, 1.0], dtype=events.dtype, device=events.device)
        total = total + unsupervised_cmax_loss(flows[key], events * scale_vec, (h // s, w // s), weights,
                                               blur_sigma=blur_sigma, tv_weight=tv_weight)
        n += 1
    return total / max(1, n)


def supervised_epe_loss(flow: Tensor, gt_flow: Tensor, t_scale=1.0) -> Tensor:
    """Mean endpoint error of dense ``[..., 2, H, W]`` flows in px/s,
    scaled by the window span ``t_scale``, against GT px displacement;
    pixels with non-finite GT are masked.  The GT is zeroed there before
    the difference (the JAX package differences first): the same values,
    and a zero gradient at a masked pixel where the JAX package's is NaN."""
    if torch.is_tensor(t_scale):
        t_scale = t_scale[..., None, None, None]
    valid = torch.isfinite(gt_flow).all(dim=-3)
    gt = torch.where(valid[..., None, :, :], gt_flow, torch.zeros_like(gt_flow))
    err = torch.sqrt(torch.square(flow * t_scale - gt).sum(dim=-3) + 1e-12)
    err = torch.where(valid, err, torch.zeros_like(err))
    return err.sum(dim=(-2, -1)) / torch.clamp(valid.sum(dim=(-2, -1)), min=1).to(err.dtype)


def make_dnn_train_state(image_size: Tuple[int, int], n_bin: int = 4, lr: float = 1e-4, seed: int = 0,
                         scale_time: float = 128.0, device="cuda", dtype=torch.float32):
    """(model, optimizer): EV-FlowNet drawn from ``seed`` on ``device`` in
    ``dtype``, and Adam with optax's defaults (betas 0.9/0.999, eps 1e-8).
    ``image_size`` is the JAX signature's; the network takes any size
    divisible by 16."""
    model = EVFlowNet(n_bin=n_bin, scale_time=scale_time, seed=seed).to(device=device, dtype=dtype)
    optimizer = optax_adam(model.parameters(), lr)
    return model, optimizer


def make_loss_fn(model: EVFlowNet, image_size: Tuple[int, int], n_bin: int = 4, multi_scale: bool = False,
                 supervised: bool = False):
    """Batch loss ``fn(events [B, N, 4], weights [B, N][, gt [B, 2, H, W]])``
    -> the mean of the per-item losses: the CMax loss of flow head 3 (full
    resolution), of every head with ``multi_scale``, or the masked mean EPE
    against the GT batch with ``supervised``."""

    def loss_fn(events: Tensor, weights: Tensor, *gt: Tensor) -> Tensor:
        flows = model(events_to_voxel_grid(events, image_size, n_bin, weights))
        if supervised:
            per_item = supervised_epe_loss(flows["flow3"], gt[0], _event_t_scale(events, weights))
        elif multi_scale:
            per_item = multi_scale_cmax_loss(flows, events, image_size, weights)
        else:
            per_item = unsupervised_cmax_loss(flows["flow3"], events, image_size, weights)
        return per_item.mean()

    return loss_fn


def dnn_train_step(model: EVFlowNet, optimizer: torch.optim.Optimizer, image_size: Tuple[int, int],
                   n_bin: int = 4, multi_scale: bool = False, supervised: bool = False):
    """(step, loss_fn): ``step(events, weights[, gt])`` takes one Adam step
    on the batch loss and returns the loss (a detached device scalar)."""
    loss_fn = make_loss_fn(model, image_size, n_bin, multi_scale, supervised)

    def step(events: Tensor, weights: Tensor, *gt: Tensor) -> Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(events, weights, *gt)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step, loss_fn


def dnn_train_step_parallel(model: EVFlowNet, optimizer: torch.optim.Optimizer, image_size: Tuple[int, int], mesh,
                            n_bin: int = 4, multi_scale: bool = False, supervised: bool = False):
    """(step, loss_fn): ``dnn_train_step``'s step over the mesh's data
    devices (``mesh.data_devices()``; a device may repeat): ``model`` on the
    lead device, a replica on each other device (parameters copied from the
    model before every step), the batch cut into equal contiguous parts
    (one per device, its batch a multiple of the data axis, as the JAX
    ``shard_map`` requires), each part's loss and gradients on its device,
    their means on the lead device in mesh order, one optimizer step there.
    ``loss_fn`` is the model's single-device batch loss."""
    import copy

    devices = list(mesh.data_devices())
    lead = devices[0]
    replicas = [model if d == lead else copy.deepcopy(model).to(d) for d in devices]
    loss_fns = [make_loss_fn(r, image_size, n_bin, multi_scale, supervised) for r in replicas]

    def step(events: Tensor, weights: Tensor, *gt: Tensor) -> Tensor:
        b = events.shape[0]
        if b % len(devices):
            raise ValueError(f"a batch of {b} does not divide over the mesh's {len(devices)} data devices")
        with torch.no_grad():
            for r in replicas:
                if r is not model:
                    for p, q in zip(r.parameters(), model.parameters()):
                        p.copy_(q)
        per = b // len(devices)
        grads, losses = None, []
        for k, (r, fn, dev) in enumerate(zip(replicas, loss_fns, devices)):
            part = [t[k * per:(k + 1) * per].to(dev) for t in (events, weights) + gt]
            loss = fn(*part)
            g = torch.autograd.grad(loss, list(r.parameters()))
            g = [x.to(lead) for x in g]
            grads = g if grads is None else [a + x for a, x in zip(grads, g)]
            losses.append(loss.detach().to(lead))
        optimizer.zero_grad(set_to_none=True)
        for p, g in zip(model.parameters(), grads):
            p.grad = g / len(devices)
        optimizer.step()
        return torch.stack(losses).mean()

    return step, make_loss_fn(model, image_size, n_bin, multi_scale, supervised)


def save_dnn_checkpoint(ckpt_dir: str, model: EVFlowNet, optimizer: torch.optim.Optimizer, step: int) -> str:
    """``torch.save`` of (model, optimizer, step) at ``<ckpt_dir>/step_<step>``
    (written to a temporary name, then renamed)."""
    path = os.path.abspath(os.path.join(ckpt_dir, f"step_{step}"))
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, CHECKPOINT_FILE + ".tmp")
    torch.save({"model": model.state_dict(), "optimizer": optimizer.state_dict(), "step": step}, tmp)
    os.replace(tmp, os.path.join(path, CHECKPOINT_FILE))
    return path


def latest_dnn_checkpoint(ckpt_dir: str) -> Optional[str]:
    """Path of the highest-step checkpoint under ``ckpt_dir`` (None if no
    checkpoints exist)."""
    if not os.path.isdir(ckpt_dir):
        return None
    best = None
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and (best is None or int(m.group(1)) > best[0]):
            best = (int(m.group(1)), os.path.join(ckpt_dir, name))
    return os.path.abspath(best[1]) if best else None


def restore_dnn_checkpoint(path: str, model: EVFlowNet, optimizer: torch.optim.Optimizer) -> int:
    """Load a port checkpoint into ``model`` and ``optimizer`` (on their
    device and dtype); returns its step.  An orbax checkpoint of the JAX
    package raises ``ValueError``."""
    file = os.path.join(path, CHECKPOINT_FILE)
    if not os.path.exists(file):
        if any(os.path.exists(os.path.join(path, m)) for m in _ORBAX_MARKERS):
            raise ValueError(
                f"{path} holds an orbax checkpoint of the JAX package, which the port does not read: "
                "carry its parameters across with models.convert.params_from_flax, or set "
                "'dnn.resume: false' or another dnn.checkpoint_dir")
        raise FileNotFoundError(f"no {CHECKPOINT_FILE} in {path}")
    state = torch.load(file, map_location="cpu", weights_only=True)
    model.load_state_dict(state["model"])
    optimizer.load_state_dict(state["optimizer"])
    return int(state["step"])


def crop_size(data_cfg: dict) -> Tuple[int, int]:
    """``data.height`` x ``data.width`` cropped to multiples of 16 (the
    network's four stride-2 encoders)."""
    return (data_cfg["height"] // 16) * 16, (data_cfg["width"] // 16) * 16


def default_scale_time(dnn_cfg: dict, image_size: Tuple[int, int]) -> float:
    """``dnn.scale_time``, the tanh heads' flow range in px per normalized
    window; the JAX package's default ``min(128, max(H, W) / 2)``."""
    return float(dnn_cfg.get("scale_time", min(128.0, max(image_size) / 2)))


def draw_batch(loader, rng, image_size: Tuple[int, int], n_events: int, batch: int, supervised: bool = False):
    """One training batch as ``run_dnn_flow`` draws it: ``batch`` windows of
    ``n_events`` from random starts (``rng``), times from 0, cropped to
    ``image_size`` and padded to ``n_events``.  Numpy (events ``[B, N, 4]``,
    weights ``[B, N]``, with ``supervised`` the GT displacement over each
    window ``[B, 2, H, W]`` in float32 as the JAX package casts it, else
    None)."""
    Hc, Wc = image_size
    total = len(loader)
    evs, wgts, gts = [], [], []
    for _ in range(batch):
        start = int(rng.integers(0, max(1, total - n_events)))
        end = min(start + n_events, total)
        ev = loader.load_event(start, end)
        if supervised:
            # [H, W, 2] loader convention -> [2, Hc, Wc] crop
            gt_hw2 = np.asarray(loader.load_optical_flow(loader.index_to_time(start), loader.index_to_time(end - 1)))
            gts.append(np.transpose(gt_hw2[:Hc, :Wc], (2, 0, 1)).astype(np.float32))
        ev[:, 2] -= ev[:, 2].min()
        ev = ev[(ev[:, 0] < Hc) & (ev[:, 1] < Wc)]
        p, w = pad_events(ev, target_n=n_events)
        evs.append(p)
        wgts.append(w)
    return np.stack(evs), np.stack(wgts), (np.stack(gts) if supervised else None)


def run_dnn_flow(config: dict, loader, device, evaluate: bool = False,
                 initial_state: Optional[dict] = None) -> dict:
    """CLI entry for ``is_dnn`` configs: train EV-FlowNet unsupervised on
    the loaded sequence (the JAX package's batch draws and resume rules),
    then (if ``evaluate``) report AEE against GT into
    ``<output_dir>/dnn_flow_error.txt``.  ``initial_state`` (a ``state_dict``)
    replaces the random init, as a checkpoint found there replaces both.
    Returns ``{"model", "losses" (per step of this run), "step_seconds"
    (host clock, each step ending in its loss's read), "eval" (per-frame
    metrics), "eval_zero_epe" (the zero flow's EPE per frame)}``."""
    data_cfg = config["data"]
    dnn_cfg = config.get("dnn", {})
    image_size = crop_size(data_cfg)
    n_bin = int(dnn_cfg.get("n_bin", 4))
    batch = int(dnn_cfg.get("batch_size", 2))
    steps = int(dnn_cfg.get("n_steps", 50))
    n_events = int(data_cfg.get("n_events_per_batch", 30000))

    model, optimizer = make_dnn_train_state(image_size, n_bin, lr=float(dnn_cfg.get("lr", 1e-4)),
                                            scale_time=default_scale_time(dnn_cfg, image_size), device=device)
    if initial_state is not None:
        model.load_state_dict(initial_state)

    ckpt_dir = dnn_cfg.get("checkpoint_dir", os.path.join(config["output"]["output_dir"], "checkpoints"))
    ckpt_every = int(dnn_cfg.get("checkpoint_every", 0))  # 0 = end only
    start_step = 0
    latest = latest_dnn_checkpoint(ckpt_dir) if dnn_cfg.get("resume", True) else None
    if latest is not None:
        start_step = restore_dnn_checkpoint(latest, model, optimizer)
        logger.info(f"restored DNN checkpoint {latest} (step {start_step})")
        if start_step >= steps and not dnn_cfg.get("eval_only"):
            logger.warning(
                f"checkpoint step {start_step} >= dnn.n_steps {steps}: training "
                "is SKIPPED and the restored model is used as-is.  If the "
                "training config changed (loss, lr, ...), set "
                "'dnn.resume: false' or point dnn.checkpoint_dir elsewhere "
                "to retrain."
            )
    elif dnn_cfg.get("eval_only"):
        raise FileNotFoundError(
            f"dnn.eval_only set but no checkpoint found under {ckpt_dir}"
            + (" (dnn.resume is false)" if not dnn_cfg.get("resume", True) else "")
        )

    supervised = bool(dnn_cfg.get("supervised"))
    if supervised and not getattr(loader, "gt_flow_available", False):
        raise ValueError(
            "dnn.supervised requires a loader with dense GT flow "
            "(data.load_gt_flow); use the unsupervised CMax loss otherwise"
        )
    if supervised and dnn_cfg.get("multi_scale"):
        logger.warning("dnn.supervised trains the full-resolution head only; "
                       "dnn.multi_scale is ignored")
    n_dev = torch.cuda.device_count() if torch.device(device).type == "cuda" else 1
    multi_scale = bool(dnn_cfg.get("multi_scale"))
    if dnn_cfg.get("data_parallel") and n_dev > 1 and batch % n_dev == 0:
        from ..parallel.sharded import make_mesh

        step, _ = dnn_train_step_parallel(model, optimizer, image_size, make_mesh(n_dev, data=n_dev), n_bin,
                                          multi_scale=multi_scale, supervised=supervised)
        logger.info(f"data-parallel DNN training over {n_dev} devices")
    else:
        step, _ = dnn_train_step(model, optimizer, image_size, n_bin, multi_scale=multi_scale, supervised=supervised)
        if dnn_cfg.get("data_parallel"):
            logger.info(f"dnn.data_parallel: {n_dev} device(s) visible for a batch of {batch}; "
                        "training on one device")

    dtype = next(model.parameters()).dtype
    total = len(loader)
    rng = np.random.default_rng(0)
    losses, seconds = [], []
    if not dnn_cfg.get("eval_only"):
        # resume determinism: replay the RNG draws of completed steps so a
        # resumed run sees the same batch sequence as an uninterrupted one
        for _ in range(start_step * batch):
            rng.integers(0, max(1, total - n_events))
        for it in range(start_step, steps):
            t0 = time.perf_counter()
            arrays = draw_batch(loader, rng, image_size, n_events, batch, supervised)
            tensors = [torch.as_tensor(a, dtype=dtype, device=device) for a in arrays if a is not None]
            # one host read per step: the loss log, and a step time that
            # holds the device's work
            losses.append(float(step(*tensors)))
            seconds.append(time.perf_counter() - t0)
            if it % 10 == 0:
                logger.info(f"dnn step {it}: loss {losses[-1]:.4f}")
            if ckpt_every and (it + 1) % ckpt_every == 0 and (it + 1) < steps:
                save_dnn_checkpoint(ckpt_dir, model, optimizer, it + 1)
        if steps > start_step:
            save_dnn_checkpoint(ckpt_dir, model, optimizer, steps)
            logger.info(f"DNN training finished; checkpoint at {ckpt_dir}/step_{steps}.")
        else:
            logger.info("DNN training already complete (checkpoint at target step).")

    results, zero_epe = [], []
    if evaluate and getattr(loader, "gt_flow_available", False):
        results, zero_epe = _evaluate_dnn(model, loader, data_cfg, image_size, n_bin, config["output"]["output_dir"])
    return {"model": model, "losses": losses, "step_seconds": seconds, "eval": results, "eval_zero_epe": zero_epe}


def _evaluate_dnn(model: EVFlowNet, loader, data_cfg: dict, image_size: Tuple[int, int], n_bin: int,
                  out_dir: str) -> list:
    """Post-training evaluation: per gray-frame window, predict a dense flow
    with the trained network and report AEE/NPE/AE against GT (the metrics
    of the CMax eval loop); writes ``dnn_flow_error.txt`` as the JAX
    package does.  Returns (the metrics per frame, the zero flow's EPE per
    frame on the same events, mask and GT)."""
    from ..flow.metrics import calculate_flow_error_numpy

    eval_dt = int(data_cfg.get("eval_dt", 1))
    eval_ts = loader.eval_frame_time_list()
    Hc, Wc = image_size
    param = next(model.parameters())
    results, zero_epe = [], []
    for i1 in range(len(eval_ts) - eval_dt):
        t1, t2 = eval_ts[i1], eval_ts[i1 + eval_dt]
        ind1, ind2 = loader.time_to_index(t1), loader.time_to_index(t2)
        ev = loader.load_event(ind1, ind2)
        gt_flow = loader.load_optical_flow(t1, t2)
        ev[:, 2] -= ev[:, 2].min()
        ev = ev[(ev[:, 0] < Hc) & (ev[:, 1] < Wc)]
        padded, wgt = pad_events(ev)  # bucketed padding: windows are variable-length
        events = torch.as_tensor(padded[None], dtype=param.dtype, device=param.device)
        weights = torch.as_tensor(wgt[None], dtype=param.dtype, device=param.device)
        with torch.no_grad():
            flow = model(events_to_voxel_grid(events, image_size, n_bin, weights))["flow3"][0].cpu().numpy()
        # network flow is px/s; GT is a displacement over [t1, t2]
        gt_2hw = np.transpose(gt_flow[:Hc, :Wc], (2, 0, 1))
        mask = np.zeros((Hc, Wc), bool)
        mask[ev[:, 0].astype(int), ev[:, 1].astype(int)] = True
        err = calculate_flow_error_numpy(gt_2hw[None], (flow * (t2 - t1))[None], event_mask=mask[None, None])
        results.append(err)
        zero_epe.append(calculate_flow_error_numpy(gt_2hw[None], np.zeros_like(gt_2hw)[None],
                                                   event_mask=mask[None, None])["EPE"])
        logger.info(f"dnn eval frame {i1}: {err}")
    if results:
        mean = {k: float(np.mean([r[k] for r in results])) for k in results[0]}
        logger.info(f"DNN eval mean over {len(results)} frames: {mean}")
        with open(f"{out_dir}/dnn_flow_error.txt", "w") as f:
            for i, r in enumerate(results):
                f.write(f"frame {i}::{r}\n")
            f.write(f"mean::{mean}\n")
    return results, zero_epe
