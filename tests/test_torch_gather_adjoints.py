"""The objective chain's static gathers as slices (``ops/blur.py``'s
``take`` and ``pad_axis``, ``ops/interp.py``'s phase lerp) against the
``index_select`` forms they replace, kept here as references, under the
port's numerics (``set_numerics``):

* the forward values bit for bit (float32 and float64): the blurs'
  reflect and symmetric pads at radius 1 and 4, ``tile_to_dense_flow`` at
  the benchmark cells' tile geometries (factors 16x21 and 28x40 with their
  clamp pads, and factor 1), ``_resize_bilinear`` on axes of length 1 and 2
  and on a resize by a factor that is not whole (the gather form);
* the gradients (``torch.autograd.grad``, ``torch.func.vjp``), ``vmap``
  over a batch of 8 and the analytic HVP's ``jvp`` of ``grad`` through
  ``cost_of_images``, to 1e-6 (float32) and 1e-12 (float64) relative;
* the objective's value-and-gradient graph for the cells' specs (every
  scale, single frame and the fleet's vmapped form) holds no
  ``index_select`` or indexing backward node: no gradient the cells take
  runs the deterministic sort-and-scatter adjoint.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from event_based_optical_flow_tpu_torch import solver as solver_pkg
from event_based_optical_flow_tpu_torch.ops import blur, interp
from event_based_optical_flow_tpu_torch.ops import fused_iwe as fi
from event_based_optical_flow_tpu_torch.solver import fleet as fleet_mod
from event_based_optical_flow_tpu_torch.solver import objective
from event_based_optical_flow_tpu_torch.utils import set_numerics

CONFIGS = Path(__file__).resolve().parents[1] / "benchmark" / "configs"
CELLS = ("mvsec-indoor-flying", "dsec-zurich-city")
TOL = {torch.float32: 1e-6, torch.float64: 1e-12}
DTYPES = (torch.float32, torch.float64)
INDEX_NODES = {"IndexSelectBackward0", "IndexBackward0", "IndexPutBackward0"}


@pytest.fixture(autouse=True)
def numerics():
    """The port's numerics, restored afterwards."""
    before = torch.are_deterministic_algorithms_enabled()
    set_numerics()
    yield
    torch.use_deterministic_algorithms(before)


# --- the index_select references ------------------------------------------------------------------------------


def _pad_index_ref(n: int, r: int, mode: str, device) -> torch.Tensor:
    idx = torch.arange(-r, n + r, device=device)
    if mode == "reflect":
        period = max(2 * (n - 1), 1)
        idx = idx.remainder(period)
        return torch.where(idx > n - 1, period - idx, idx)
    if mode == "symmetric":
        idx = idx.remainder(2 * n)
        return torch.where(idx > n - 1, 2 * n - 1 - idx, idx)
    return idx.clamp(0, n - 1)


def _separable_blur_ref(image, kernel, pad_mode):
    k, r = len(kernel), len(kernel) // 2
    h, w = image.shape[-2], image.shape[-1]
    padded = image.index_select(-2, _pad_index_ref(h, r, pad_mode, image.device))
    out = sum(kernel[i] * padded[..., i : i + h, :] for i in range(k))
    padded = out.index_select(-1, _pad_index_ref(w, r, pad_mode, image.device))
    return sum(kernel[i] * padded[..., :, i : i + w] for i in range(k))


def _resize_bilinear_ref(img, out_hw):
    in_h, in_w = img.shape[-2:]
    oh, ow = out_hw
    ys = (np.arange(oh) + 0.5) * in_h / oh - 0.5
    xs = (np.arange(ow) + 0.5) * in_w / ow - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, in_h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, in_w - 1)
    y1, x1 = np.clip(y0 + 1, 0, in_h - 1), np.clip(x0 + 1, 0, in_w - 1)
    wy = torch.as_tensor(np.clip(ys - y0, 0.0, 1.0), dtype=img.dtype, device=img.device)
    wx = torch.as_tensor(np.clip(xs - x0, 0.0, 1.0), dtype=img.dtype, device=img.device)
    y0, y1, x0, x1 = (torch.as_tensor(a, device=img.device) for a in (y0, y1, x0, x1))
    rows0, rows1 = img.index_select(-2, y0), img.index_select(-2, y1)
    a, b = rows0.index_select(-1, x0), rows0.index_select(-1, x1)
    c, d = rows1.index_select(-1, x0), rows1.index_select(-1, x1)
    top = a * (1 - wx)[None, :] + b * wx[None, :]
    bot = c * (1 - wx)[None, :] + d * wx[None, :]
    return top * (1 - wy)[:, None] + bot * wy[:, None]


def _tile_to_dense_ref(motion, patch_image_size, image_shape, patch_size, sliding_window, patch_shift):
    pad_h = int(patch_size[0] / 2 // sliding_window[0]) + patch_shift[0] // sliding_window[0] + 1
    pad_w = int(patch_size[1] / 2 // sliding_window[1]) + patch_shift[1] // sliding_window[1] + 1
    arr = -motion.reshape((2,) + tuple(patch_image_size))
    for axis, pad in ((-2, pad_h), (-1, pad_w)):
        n = arr.shape[axis]
        arr = arr.index_select(axis, torch.as_tensor(np.clip(np.arange(-pad, n + pad), 0, n - 1), device=arr.device))
    dense = _resize_bilinear_ref(arr, (arr.shape[1] * sliding_window[0], arr.shape[2] * sliding_window[1]))
    cx, cy = dense.shape[1] // 2, dense.shape[2] // 2
    h1, w1 = cx - image_shape[0] // 2, cy - image_shape[1] // 2
    return dense[..., h1 : h1 + image_shape[0], w1 : w1 + image_shape[1]]


# --- helpers ----------------------------------------------------------------------------------------------------


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> None:
    assert a.shape == b.shape and a.dtype == b.dtype
    ints = torch.int32 if a.dtype == torch.float32 else torch.int64
    diff = (a.contiguous().view(ints) != b.contiguous().view(ints)).sum().item()
    assert diff == 0, f"{diff} of {a.numel()} values differ in their bits"


def _close(a: torch.Tensor, b: torch.Tensor, tol: float) -> None:
    scale = b.abs().max().item()
    err = (a - b).abs().max().item()
    assert err <= tol * max(scale, 1e-30), f"max|err| {err:.3e} over max|ref| {scale:.3e}"


def _grads(fn, x, g):
    xr = x.detach().clone().requires_grad_(True)
    (out,) = torch.autograd.grad(fn(xr), xr, g)
    return out


def _cell_geometries():
    """(cell, scale, spec) of every pyramid scale of the benchmark cells'
    configurations, as the port's pyramid solver sets them."""
    out = []
    for name in CELLS:
        port = json.loads((CONFIGS / f"{name}.json").read_text())["port"]
        data = port["data"]
        solv = solver_pkg.collections[port["solver"]["method"]](
            (data["height"], data["width"]), calibration_parameter={}, solver_config=port["solver"],
            optimizer_config=port["optimizer"], output_config=port["output"], device="cpu")
        for s in range(solv.coarsest_scale, solv.patch_scales):
            solv.overload_patch_configuration(s)
            out.append((name, s, solv._current_spec()))
    return out


GEOMETRIES = _cell_geometries()
FINEST = [g for g in GEOMETRIES if g[1] == 4]


def _tile_args(spec):
    return (spec.patch_image_size, spec.image_shape, spec.patch_size, spec.sliding_window, spec.patch_shift)


# --- forward bits -----------------------------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 3, 26, 35), (3, 1, 7), (3, 2, 5), (4, 1), (2, 9), (1, 1)])
@pytest.mark.parametrize("mode,radius", [("reflect", 1), ("reflect", 4), ("symmetric", 1), ("symmetric", 4)])
def test_blur_forward_bits(dtype, shape, mode, radius):
    """``_separable_blur`` equals the index_select pads' blur bit for bit,
    axes of length 1 and 2 included (pads wider than the axis)."""
    torch.manual_seed(1)
    image = torch.randn(shape, dtype=dtype)
    kernel = blur._gaussian_kernel1d(1.0, radius)
    _bits_equal(blur._separable_blur(image, kernel, mode), _separable_blur_ref(image, kernel, mode))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cell,scale,spec", GEOMETRIES, ids=[f"{c}-s{s}" for c, s, _ in GEOMETRIES])
def test_tile_to_dense_forward_bits(dtype, cell, scale, spec):
    """``tile_to_dense_flow`` at each scale of the cells' tile geometries
    (the finest: factors 16x21 and 28x40) equals the reference bit for bit."""
    torch.manual_seed(scale)
    motion = torch.randn(2 * spec.patch_image_size[0] * spec.patch_image_size[1], dtype=dtype) * 50
    _bits_equal(interp.tile_to_dense_flow(motion, *_tile_args(spec)), _tile_to_dense_ref(motion, *_tile_args(spec)))


RESIZES = [((5, 6), (80, 126)), ((3, 4), (84, 160)), ((4, 4), (4, 4)), ((1, 2), (16, 42)), ((2, 1), (56, 40)),
           ((1, 1), (3, 5)), ((6, 7), (10, 11)), ((6, 8), (3, 4)), ((5, 6), (15, 13))]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("in_hw,out_hw", RESIZES)
def test_resize_bilinear_forward_bits(dtype, in_hw, out_hw):
    """``_resize_bilinear`` equals the four gathers and a lerp bit for bit:
    whole factors (the phase form; factor 1; axes of length 1 and 2), and
    factors that are not whole or shrink (the gather form)."""
    torch.manual_seed(2)
    img = torch.randn((2,) + in_hw, dtype=dtype)
    _bits_equal(interp._resize_bilinear(img, out_hw), _resize_bilinear_ref(img, out_hw))


# --- gradients and transforms -----------------------------------------------------------------------------------


def _chain_cases():
    """(name, fn, reference fn, input shape) of each rewritten map."""
    k1, k4 = blur._gaussian_kernel1d(1.0, 1), blur._gaussian_kernel1d(1.0, 4)
    cases = [
        ("blur3", lambda x: blur._separable_blur(x, k1, "reflect"),
         lambda x: _separable_blur_ref(x, k1, "reflect"), (3, 20, 27)),
        ("blur9-symmetric", lambda x: blur._separable_blur(x, k4, "symmetric"),
         lambda x: _separable_blur_ref(x, k4, "symmetric"), (3, 11, 13)),
        ("blur3-thin", lambda x: blur._separable_blur(x, k1, "reflect"),
         lambda x: _separable_blur_ref(x, k1, "reflect"), (2, 1, 2)),
        ("resize-whole", lambda x: interp._resize_bilinear(x, (48, 84)),
         lambda x: _resize_bilinear_ref(x, (48, 84)), (2, 3, 4)),
        ("resize-gather", lambda x: interp._resize_bilinear(x, (10, 11)),
         lambda x: _resize_bilinear_ref(x, (10, 11)), (2, 6, 7)),
    ]
    for cell, _, spec in FINEST:
        args = _tile_args(spec)
        n = 2 * spec.patch_image_size[0] * spec.patch_image_size[1]
        cases.append((f"tiles-{cell}", lambda m, a=args: interp.tile_to_dense_flow(m, *a),
                      lambda m, a=args: _tile_to_dense_ref(m, *a), (n,)))
    return cases


CASES = _chain_cases()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name,fn,ref,shape", CASES, ids=[c[0] for c in CASES])
def test_gradients_match_reference(dtype, name, fn, ref, shape):
    """``torch.autograd.grad`` and ``torch.func.vjp`` of each map against
    the reference's autograd gradient."""
    torch.manual_seed(3)
    x = torch.randn(shape, dtype=dtype)
    g = torch.randn(fn(x).shape, dtype=dtype)
    want = _grads(ref, x, g)
    _close(_grads(fn, x, g), want, TOL[dtype])
    _close(torch.func.vjp(fn, x)[1](g)[0], want, TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name,fn,ref,shape", CASES, ids=[c[0] for c in CASES])
def test_vmap_over_a_batch_of_8(dtype, name, fn, ref, shape):
    """``torch.func.vmap`` over 8 inputs (the fleet's ``_batched_flow`` and
    ``_over_frames``): each output the reference's bits, the vjp of the
    batch the reference's per-input gradients."""
    torch.manual_seed(4)
    xs = torch.randn((8,) + shape, dtype=dtype)
    out, vjp = torch.func.vjp(torch.func.vmap(fn), xs)
    _bits_equal(out, torch.stack([ref(x) for x in xs]))
    g = torch.randn(out.shape, dtype=dtype)
    _close(vjp(g)[0], torch.stack([_grads(ref, x, gi) for x, gi in zip(xs, g)]), TOL[dtype])


def _cost_problem(dtype):
    """A small hybrid-cost spec, three direction images and tile motions."""
    spec = objective.ObjectiveSpec(
        image_shape=(30, 42), patch_image_size=(3, 3), patch_size=(10, 14), sliding_window=(10, 14),
        patch_shift=(0, 0), filter_type="bilinear", blur_sigma=1, cost_name="hybrid",
        cost_with_weight=(("multi_focal_normalized_gradient_magnitude", 1.0), ("total_variation", 0.01)))
    gen = torch.Generator().manual_seed(5)
    images = torch.rand((3, 30, 42), generator=gen, dtype=dtype) * 4
    orig = torch.rand((30, 42), generator=gen, dtype=dtype) * 4
    motion = torch.randn(18, generator=gen, dtype=dtype) * 10
    dimages = torch.randn((3, 30, 42), generator=gen, dtype=dtype)
    p = torch.randn(18, generator=gen, dtype=dtype)
    return spec, images, orig, motion, dimages, p


def _jvp_of_grad(spec, images, orig, motion, dimages, p):
    """The analytic HVP's pattern (``objective._hvp_assembly``): ``jvp`` of
    the cost's ``grad`` along (dimages, p)."""
    _, cost_of = objective.cost_of_images(spec)
    grad_cost = torch.func.grad(lambda ii, mm, oo: cost_of(ii, mm, oo)[0], argnums=(0, 1))
    return torch.func.jvp(lambda ii, mm: grad_cost(ii, mm, orig), (images, motion), (dimages, p))


@pytest.mark.parametrize("dtype", DTYPES)
def test_jvp_of_grad_through_cost_of_images(dtype, monkeypatch):
    """Forward-over-reverse through the blur's pads (the analytic HVP's
    ``torch.func.jvp(grad_cost)``) against the reference blur's."""
    problem = _cost_problem(dtype)
    (g1, gm), (h1, hm) = _jvp_of_grad(*problem)
    monkeypatch.setattr(objective, "gaussian_blur3",
                        lambda img, sigma: _separable_blur_ref(img, blur._gaussian_kernel1d(float(sigma), 1),
                                                               "reflect"))
    (r1, rm), (s1, sm) = _jvp_of_grad(*problem)
    for got, want in ((g1, r1), (gm, rm), (h1, s1), (hm, sm)):
        _close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cell,scale,spec", FINEST, ids=[c for c, _, _ in FINEST])
def test_jvp_of_grad_through_tile_to_dense(dtype, cell, scale, spec):
    """Forward-over-reverse through the finest tile map (clamp pad and
    phase lerp) against the reference map's, batched by ``vmap`` as the
    fleet's HVP maps its frames."""
    gen = torch.Generator().manual_seed(6)
    n = 2 * spec.patch_image_size[0] * spec.patch_image_size[1]
    motion = torch.randn((8, n), generator=gen, dtype=dtype) * 20
    p = torch.randn((8, n), generator=gen, dtype=dtype)
    weight = torch.rand((2,) + spec.image_shape, generator=gen, dtype=dtype)

    def hvp(tile_map):
        loss = lambda m: (weight * tile_map(m, *_tile_args(spec)) ** 3).sum()  # noqa: E731
        return torch.func.vmap(lambda m, v: torch.func.jvp(torch.func.grad(loss), (m,), (v,)))(motion, p)

    for got, want in zip(hvp(interp.tile_to_dense_flow), hvp(_tile_to_dense_ref)):
        _close(got, want, TOL[dtype])


# --- the objective's gradient graph -----------------------------------------------------------------------------


def _graph_nodes(root) -> set:
    """The names of every node of an autograd graph."""
    seen, names, stack = set(), set(), [root]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.add(type(fn).__name__)
        stack.extend(nxt for nxt, _ in fn.next_functions)
    return names


def _frame_events(spec, n_frames: int, seed: int):
    """``n_frames`` tiny frames of ~400 events at the spec's sensor size."""
    rng = np.random.default_rng(seed)
    h, w = spec.image_shape
    out = []
    for _ in range(n_frames):
        n = 400
        x, y = rng.uniform(1, h - 2, n), rng.uniform(1, w - 2, n)
        out.append(np.stack([np.round(x), np.round(y), np.sort(rng.uniform(0, 0.05, n)),
                             rng.integers(0, 2, n)], 1))
    return out


class _KernelPairOnCpu(torch.autograd.Function):
    """``ops.fused_iwe.FusedIWE``'s contract on the CPU: the kernels' plain
    forward, and their plain VJP as its backward, one node of the graph
    (the CPU's ``fused_iwe`` is the plain vote itself, whose own gathers
    and scatters stand for the CUDA kernel pair, not for the chain)."""

    @staticmethod
    def forward(ctx, flow, x, y, dtf, wt, bins, frames, offsets, include_orig, eps, pad):
        ctx.save_for_backward(flow, x, y, dtf, wt)
        ctx.config = (bins, frames, offsets, include_orig, eps, pad)
        return fi.fused_iwe_reference(flow, x, y, dtf, wt, offsets, include_orig, eps, bins, frames, pad)

    @staticmethod
    def backward(ctx, g):
        flow, x, y, dtf, wt = ctx.saved_tensors
        bins, frames, offsets, include_orig, eps, pad = ctx.config
        return (fi.fused_iwe_bwd(flow, x, y, dtf, wt, g, offsets, include_orig, eps, bins, frames, pad),) + \
            (None,) * 10


def _kernel_pair(flow, x, y, dtf, wt, offsets, include_orig, eps=1e-6, bins=None, frames=None, pad=0, count=False):
    assert not count
    return _KernelPairOnCpu.apply(flow, x, y, dtf, wt, bins, frames, tuple(offsets), include_orig, eps, pad)


@pytest.mark.parametrize("fleet", [False, True], ids=["single", "fleet"])
@pytest.mark.parametrize("cell,scale,spec", GEOMETRIES, ids=[f"{c}-s{s}" for c, s, _ in GEOMETRIES])
def test_objective_gradient_has_no_index_backward(cell, scale, spec, fleet, monkeypatch):
    """The value-and-gradient graph of the cells' objective at every scale
    (single frame: ``build_objective``; the fleet: ``build_batched_objective``,
    vmapped over 2 frames), the vote one node as on the card, has no
    ``index_select`` / indexing backward node, and its gradient is finite."""
    monkeypatch.setattr(objective, "fused_iwe", _kernel_pair)
    monkeypatch.setattr(fi, "fused_iwe", _kernel_pair)
    n_motion = 2 * spec.patch_image_size[0] * spec.patch_image_size[1]
    rng = np.random.default_rng(scale)
    if fleet:
        events = objective.FleetEvents.from_numpy(_frame_events(spec, 2, scale), "cpu", torch.float64)
        orig = fleet_mod.build_orig_iwe_batched(spec)(events)
        motion = torch.as_tensor(rng.uniform(-40, 40, (2, n_motion))).requires_grad_(True)
        loss = fleet_mod.build_batched_objective(spec)(motion, orig, events).sum()
    else:
        frame = objective.FrameEvents.from_numpy(_frame_events(spec, 1, scale)[0], "cpu", torch.float64)
        orig = objective.build_orig_iwe(spec)(frame)
        motion = torch.as_tensor(rng.uniform(-40, 40, n_motion)).requires_grad_(True)
        loss = objective.build_objective(spec)(motion, orig, frame)[0]
    nodes = _graph_nodes(loss.grad_fn)
    assert not nodes & INDEX_NODES, sorted(nodes & INDEX_NODES)
    assert {"CatBackward0", "ExpandBackward0"} <= nodes  # the pads' and the phase lerp's slices
    (grad,) = torch.autograd.grad(loss, motion)
    assert torch.isfinite(grad).all()
