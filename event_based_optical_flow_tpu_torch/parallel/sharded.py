"""Sharded CMax over a grid of devices (port of
``event_based_optical_flow_tpu/parallel/sharded.py``).

Layout: a 2-D mesh ("data", "event") of ``torch.device`` s, driven by ONE
process, as the JAX package's single controller drives its mesh.  Frames
(event windows) shard over "data"; within a frame, events shard over
"event": each shard votes its events on its own device, and the partial
images are reduced on the row's lead device (its first), in mesh order.
Time statistics (masked t_min / t_max) are global per frame: the shards'
minima and maxima are reduced too, as the JAX package's pmin/pmax reduce
them.

Every vote here is K8 (``ops/vote.py``): on the card each shard's vote
writes its int64 fixed-point sums (``vote_acc``), the sums are added as
integers and converted once (``vote_from_fixed``), so a sharded image is
the unsharded vote's bits, not only its values (the JAX package's ``psum``
of float images matches its single device up to summation order).  On the
CPU each shard votes with the plain version and the float images add, as
``psum`` adds them.  Gradients w.r.t. the warped positions flow through
``ShardedVote``: the image cotangent is copied to each shard, whose events
take K8's four-corner backward (``vote._vote_backward``) there.

A mesh may repeat a device: ``make_mesh(devices=[cuda:0] * 4)`` runs every
partition and every reduction on one card (the JAX tests' virtual CPU
devices are the same idea), which is how a one-card machine checks the
layer; real speed-ups need distinct devices.

``pad_chunks_for_sharding`` (TPU band packing) and ``fleet_shardings``
(``jax.sharding.NamedSharding`` s) do not carry over: a shard here is a
contiguous slice of events on a device, cut by ``FrameEvents.shard`` at
run boundaries (the solvers' objective) or evenly (``sharded_iwe``).
"""

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..costs import functional as F
from ..costs.functional import nan_to_penalty
from ..ops.blur import gaussian_blur3
from ..ops.interp import tile_to_dense_flow
from ..ops.vote import _vote_backward, bilinear_vote_plain, vote_acc, vote_from_fixed

Tensor = torch.Tensor


@dataclass(frozen=True)
class Mesh:
    """A ``[data, event]`` grid of devices (``grid[d][e]``; a device may
    repeat) with the JAX mesh's axis names."""

    grid: Tuple[Tuple[torch.device, ...], ...]
    axis_names: Tuple[str, str] = ("data", "event")

    @property
    def devices(self) -> np.ndarray:
        """The grid as a ``[data, event]`` object array (``jax.sharding.Mesh.devices``)."""
        arr = np.empty((len(self.grid), len(self.grid[0])), dtype=object)
        for d, row in enumerate(self.grid):
            for e, dev in enumerate(row):
                arr[d, e] = dev
        return arr

    @property
    def shape(self) -> dict:
        return {"data": len(self.grid), "event": len(self.grid[0])}

    @property
    def size(self) -> int:
        return len(self.grid) * len(self.grid[0])

    @property
    def lead(self) -> torch.device:
        """Where reductions land: the first device."""
        return self.grid[0][0]

    def event_devices(self, d: int = 0) -> Tuple[torch.device, ...]:
        """Data shard ``d``'s row: the devices a frame's events shard over."""
        return self.grid[d]

    def data_devices(self) -> Tuple[torch.device, ...]:
        """Each data shard's lead device."""
        return tuple(row[0] for row in self.grid)


def make_mesh(n_devices: Optional[int] = None, data: Optional[int] = None, event: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a ("data", "event") mesh over the first ``n_devices`` devices:
    the visible CUDA devices, or ``devices`` (any list, a device may
    repeat).  Raises when there are too few; never falls back to the CPU."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh takes the visible CUDA devices and sees none; pass devices= "
                               "(e.g. [torch.device('cpu')] * k) for a mesh of other devices")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_devices is None:
        n_devices = len(devices)
    if data is None:
        data = n_devices // event
    assert data * event == n_devices, f"{data}x{event} != {n_devices}"
    if n_devices > len(devices):
        raise ValueError(f"a {data}x{event} mesh needs {n_devices} devices, {len(devices)} are available")
    return Mesh(tuple(tuple(devices[d * event:(d + 1) * event]) for d in range(data)))


def _split(t: Tensor, devices: Sequence[torch.device]) -> list:
    """``t`` cut into ``len(devices)`` contiguous even pieces along axis 0
    (``torch.tensor_split``), piece s on ``devices[s]``."""
    return [piece.to(dev) for piece, dev in zip(torch.tensor_split(t, len(devices)), devices)]


def sum_on(parts, lead: torch.device, like: Optional[Tensor] = None) -> Tensor:
    """The partials added on ``lead`` in mesh order (zeros like ``like``
    for none): the layer's one reduction, of float images and gradients
    and of int64 fixed-point sums alike."""
    total = None
    for part in parts:
        part = part.to(lead)
        total = part if total is None else total + part
    return torch.zeros_like(like) if total is None else total


class ShardedVote(torch.autograd.Function):
    """The bilinear vote of event shards (``[..., n_s, 4]`` and weights
    ``[..., n_s]`` per shard, each on its device) into one ``[..., H, W]``
    image on ``lead``: on the card K8's int64 sums per shard, added as
    integers, converted once; on the CPU the plain votes added.  The
    backward copies the cotangent to every shard and gives each shard's
    events K8's four-corner backward there."""

    @staticmethod
    def forward(ctx, image_size, lead, eps, *shards):
        n = len(shards) // 2
        events, weights = shards[:n], shards[n:]
        ctx.save_for_backward(*shards)
        ctx.config = (eps, n)
        if lead.type == "cpu":
            return sum_on((bilinear_vote_plain(e, image_size, w, eps) for e, w in zip(events, weights)), lead)
        total = sum_on((vote_acc(e, image_size, w, eps) for e, w in zip(events, weights)), lead)
        return vote_from_fixed(total, events[0].dtype)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        eps, n = ctx.config
        d_events, d_weights = [], []
        for s, (e, w) in enumerate(zip(saved[:n], saved[n:])):
            de, dw = _vote_backward(e, torch.broadcast_to(w, e.shape[:-1]), g.to(e.device), eps)
            d_events.append(de)
            d_weights.append(dw.sum_to_size(w.shape) if ctx.needs_input_grad[3 + n + s] else None)
        return (None, None, None) + tuple(d_events) + tuple(d_weights)


def sharded_vote(events: Sequence[Tensor], weights: Sequence[Tensor], image_size, lead: torch.device,
                 eps: float = 1e-6) -> Tensor:
    """``ShardedVote`` of the shards ``events[s]``, ``weights[s]``."""
    return ShardedVote.apply(tuple(int(s) for s in image_size), torch.device(lead), float(eps), *events, *weights)


def _row(mesh: Mesh, d: int = 0):
    return mesh.event_devices(d), mesh.event_devices(d)[0]


def _partial_iwe(events: Sequence[Tensor], weights: Sequence[Tensor], image_size, lead, blur_sigma: float):
    """The shards' IWE reduced on ``lead``; the blur applied once, after
    the reduction (``_partial_iwe`` of the JAX package)."""
    full = sharded_vote(events, weights, image_size, lead)
    if blur_sigma > 0:
        full = gaussian_blur3(full, blur_sigma)
    return full


def sharded_iwe(events: Tensor, weights: Tensor, image_size, mesh: Mesh, blur_sigma: float = 0.0,
                row: int = 0) -> Tensor:
    """Event-sharded IWE of a single frame: events ``[N, 4]`` (weights
    ``[N]``) cut evenly over data shard ``row``'s event axis; the ``[H,
    W]`` image on the row's lead device."""
    devices, lead = _row(mesh, row)
    return _partial_iwe(_split(events, devices), _split(weights, devices), tuple(image_size), lead, blur_sigma)


def _masked_stats_sharded(ts: Sequence[Tensor], ws: Sequence[Tensor], lead: torch.device):
    """Global (t_min, t_max) of one frame across its event shards."""
    big = torch.finfo(ts[0].dtype).max
    mins = [torch.where(w > 0, t, t.new_tensor(big)).amin() if t.numel() else t.new_tensor(big)
            for t, w in zip(ts, ws)]
    maxs = [torch.where(w > 0, t, t.new_tensor(-big)).amax() if t.numel() else t.new_tensor(-big)
            for t, w in zip(ts, ws)]
    t_min = torch.stack([m.to(lead) for m in mins]).amin()
    t_max = torch.stack([m.to(lead) for m in maxs]).amax()
    return t_min, t_max


def sharded_multifocal_loss(
    motion: Tensor,
    events: Tensor,
    weights: Tensor,
    image_size: Tuple[int, int],
    patch_image_size: Tuple[int, int],
    patch_size: Tuple[int, int],
    sliding_window: Tuple[int, int],
    patch_shift: Tuple[int, int] = (0, 0),
    blur_sigma: float = 1.0,
    tv_weight: float = 0.01,
    mesh: Optional[Mesh] = None,
    row: int = 0,
) -> Tensor:
    """One frame's hybrid CMax loss with its events ``[N, 4]`` (weights
    ``[N]``) cut evenly over data shard ``row``'s event axis of ``mesh``
    (the JAX function's body, there inside ``shard_map``): the three warps
    are computed per shard on its events (the flow gathered at the clipped
    source pixel, from the dense tile flow copied to the shard), the four
    IWEs reduced on the lead device, where the cost and TV run once.
    Differentiable w.r.t. ``motion`` (on the lead device)."""
    h, w = image_size
    devices, lead = _row(mesh, row)
    ev_s, wt_s = _split(events, devices), _split(weights, devices)
    t_min, t_max = _masked_stats_sharded([e[:, 2] for e in ev_s], wt_s, lead)
    span = torch.where(t_max > t_min, t_max - t_min, torch.ones_like(t_max))
    t_scale = t_max - t_min
    dense = tile_to_dense_flow(motion, patch_image_size, image_size, patch_size, sliding_window,
                               patch_shift) * t_scale
    flat = dense.reshape(2, -1)
    warped = []
    for ev in ev_s:
        fl, sp = flat.to(ev.device), span.to(ev.device)
        ix = ev[:, 0].to(torch.int32).clamp(0, h - 1).long()
        iy = ev[:, 1].to(torch.int32).clamp(0, w - 1).long()
        lin = ix * w + iy
        u, v = fl[0, lin], fl[1, lin]
        stack = [ev]
        for ref in (t_min, t_max, (t_min + t_max) * 0.5):  # backward, forward, middle
            dt = (ev[:, 2] - ref.to(ev.device)) / sp
            stack.append(torch.stack([ev[:, 0] - dt * u, ev[:, 1] - dt * v, dt, ev[:, 3]], dim=1))
        warped.append(torch.stack(stack))  # [4, n_s, 4]: orig, bwd, fwd, mid
    images = _partial_iwe(warped, wt_s, tuple(image_size), lead, blur_sigma)
    orig, bwd, fwd, mid = images[0], images[1], images[2], images[3]
    loss = F.multi_focal_normalized_gradient_magnitude(orig, fwd, bwd, mid, omit_boundary=True)
    loss = loss + tv_weight * F.total_variation(motion.reshape((2,) + tuple(patch_image_size)))
    return nan_to_penalty(loss)


def build_objective_banded_sharded(spec, mesh: Mesh):
    """Event-sharded CMax objective of the solvers (the JAX package's thin
    delegate to ``build_objective_banded(mesh=...)``):
    ``fn(motion_flat, orig_blurred, frame) -> (loss, components)`` of
    ``solver/objective.py::build_objective(spec, mesh=mesh)``, which cuts a
    ``FrameEvents`` over the mesh's first row (or takes the
    ``ShardedFrame`` a solver cut once) and gives the single-device
    objective's bits on the card."""
    from ..solver.objective import build_objective

    return build_objective(spec, mesh=mesh)


def build_fleet_step(
    mesh: Mesh,
    image_size: Tuple[int, int],
    patch_image_size: Tuple[int, int],
    patch_size: Tuple[int, int],
    sliding_window: Tuple[int, int],
    lr: float = 0.5,
):
    """The multi-frame gradient step under the mesh:

    * frames shard over "data" (data shard d owns frames ``[d B/D, (d + 1)
      B/D)``, on its row),
    * each frame's events shard over "event" (``sharded_multifocal_loss``),
    * each frame's tile motion takes one gradient step; the mean loss is
      each data shard's mean, averaged over the shards in mesh order.

    ``step(motions [B, M], events [B, N, 4], weights [B, N]) -> (motions',
    mean_loss)``, both on the mesh's lead device; B divisible by the data
    axis (as the JAX ``shard_map`` requires).
    """
    n_data = mesh.shape["data"]

    def per_frame(motion, events, weights, row):
        motion = motion.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = sharded_multifocal_loss(motion, events, weights, image_size, patch_image_size, patch_size,
                                           sliding_window, mesh=mesh, row=row)
            (grad,) = torch.autograd.grad(loss, motion)
        return loss.detach(), grad

    def step(motions: Tensor, events: Tensor, weights: Tensor):
        b = motions.shape[0]
        if b % n_data:
            raise ValueError(f"a batch of {b} frames does not divide over the mesh's {n_data} data shards")
        per = b // n_data
        new, means = [], []
        for d in range(n_data):
            lead = mesh.event_devices(d)[0]
            losses = []
            for i in range(d * per, (d + 1) * per):
                m = motions[i].to(lead)
                loss, grad = per_frame(m, events[i], weights[i], d)
                new.append((m - lr * grad).to(mesh.lead))
                losses.append(loss)
            means.append(torch.stack(losses).mean().to(mesh.lead))
        return torch.stack(new), torch.stack(means).mean()

    return step
