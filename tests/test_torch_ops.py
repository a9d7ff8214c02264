"""The port's L1 ops and costs against the JAX package at float64 and
against the original reference's golden fixtures
(``tests/golden/reference_oracle.npz``) where a key exists.

Tolerances: 1e-10 absolute where both sides sum the same terms (votes,
stencils, warps); 1e-12 relative for scalar costs; the golden fixtures
with the JAX package's own tolerances.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from event_based_optical_flow_tpu import ops as jops
from event_based_optical_flow_tpu.costs import functional as JF
from event_based_optical_flow_tpu.costs import registry as JR
from event_based_optical_flow_tpu.flow.metrics import calculate_flow_error_numpy
from event_based_optical_flow_tpu.ops import interp as JI
from event_based_optical_flow_tpu.ops import warp as JW
from event_based_optical_flow_tpu.ops.iwe import EventImageConverter
from event_based_optical_flow_tpu_torch.costs import functional as TF
from event_based_optical_flow_tpu_torch.costs import registry as TR
from event_based_optical_flow_tpu_torch.flow.metrics import calculate_flow_error
from event_based_optical_flow_tpu_torch.ops import blur as TB
from event_based_optical_flow_tpu_torch.ops import interp as TI
from event_based_optical_flow_tpu_torch.ops import iwe as TV
from event_based_optical_flow_tpu_torch.ops import sobel as TS
from event_based_optical_flow_tpu_torch.ops import warp as TW

GOLDEN = np.load(os.path.join(os.path.dirname(__file__), "golden", "reference_oracle.npz"))
H, W = 24, 30


def t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _events(n=500, seed=0, h=H, w=W):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(-1.5, h + 0.5, n), rng.uniform(-1.5, w + 0.5, n),
                     np.sort(rng.uniform(0, 0.3, n)), rng.integers(0, 2, n)], 1)


# ----------------------------------------------------------------- votes
def test_bilinear_vote_golden():
    np.testing.assert_allclose(TV.bilinear_vote(t(GOLDEN["events"]), (H, W)).numpy(), GOLDEN["iwe"], atol=1e-10)


@pytest.mark.parametrize("blur_mode,key", [("torch", "iwe_blur_torch"), ("scipy", "iwe_blur_scipy")])
def test_create_iwe_blur_golden(blur_mode, key):
    out = TV.create_iwe(t(GOLDEN["events"]), (H, W), sigma=1, blur_mode=blur_mode)
    np.testing.assert_allclose(out.numpy(), GOLDEN[key], atol=1e-10)


def test_batched_weighted_vote_matches_jax_scatter():
    """[P, K, n, 4] events with [P, 1, n] weights in one scatter == one JAX
    scatter vote per image."""
    rng = np.random.default_rng(1)
    ev = np.stack([_events(200, seed=s, h=8, w=10) for s in range(6)]).reshape(3, 2, 200, 4)
    wgt = rng.uniform(0, 1.5, (3, 1, 200))
    wgt[..., 150:] = 0.0
    got = TV.bilinear_vote(t(ev), (8, 10), weight=t(wgt)).numpy()
    for p in range(3):
        for k in range(2):
            want = jops.bilinear_vote(jnp.asarray(ev[p, k]), (8, 10), weight=jnp.asarray(wgt[p, 0]), backend="scatter")
            np.testing.assert_allclose(got[p, k], np.asarray(want), atol=1e-10)


def test_vote_gradient_matches_jax():
    ev = _events()
    g = np.random.default_rng(2).normal(size=(H, W))
    import jax

    want = jax.grad(lambda e: jnp.sum(jops.bilinear_vote(e, (H, W), backend="scatter") * g))(jnp.asarray(ev))
    et = t(ev).requires_grad_(True)
    (got,) = torch.autograd.grad((TV.bilinear_vote(et, (H, W)) * t(g)).sum(), et)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-10)


def test_event_mask_matches_jax():
    ev = _events()
    want = np.asarray(EventImageConverter((H, W)).create_eventmask(jnp.asarray(ev)))
    np.testing.assert_array_equal(TV.event_mask(t(ev), (H, W)).numpy(), want)


# ----------------------------------------------------------------- warps
@pytest.mark.parametrize("direction", ["first", "middle", "last", 0.3])
def test_reftime_and_warp_2dof_match_jax(direction):
    ev = _events()
    wgt = (np.arange(len(ev)) < 450).astype(float)
    ref_j = JW.calculate_reftime(jnp.asarray(ev), direction, jnp.asarray(wgt))
    ref_t = TW.calculate_reftime(t(ev), direction, t(wgt))
    assert float(ref_t) == pytest.approx(float(ref_j), abs=1e-15)
    motion = np.array([7.5, -3.25])
    want = JW.warp_2dof(jnp.asarray(ev), jnp.asarray(motion), ref_j, normalize_t=True, weights=jnp.asarray(wgt))
    got = TW.warp_2dof(t(ev), t(motion), ref_t, normalize_t=True, weights=t(wgt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-12)


def test_warp_2dof_golden():
    events = t(GOLDEN["int_events"])
    out = TW.warp_2dof(events, t(GOLDEN["motion2"]), TW.calculate_reftime(events, "first"), normalize_t=True)
    np.testing.assert_allclose(out.numpy(), GOLDEN["w2dof"], atol=1e-10)


def test_warp_dense_golden():
    events = t(GOLDEN["int_events"])
    out = TW.warp_dense_flow(events, t(GOLDEN["dense"]), TW.calculate_reftime(events, "middle"), (H, W), normalize_t=True)
    np.testing.assert_allclose(out.numpy(), GOLDEN["wdense"], atol=1e-10)


def test_multi_direction_dense_warp_matches_jax():
    ev = _events()
    wgt = (np.arange(len(ev)) < 470).astype(float)
    flow = np.random.default_rng(3).uniform(-5, 5, (2, H, W))
    want = JW.multi_direction_dense_warp(jnp.asarray(ev), jnp.asarray(flow), [0.0, 1.0, 0.5], (H, W), jnp.asarray(wgt))
    got = TW.multi_direction_dense_warp(t(ev), t(flow), [0.0, 1.0, 0.5], (H, W), t(wgt))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-12)


# ------------------------------------------------------- blur and sobel
@pytest.mark.parametrize("shape", [(H, W), (3, 2, 7, 9), (2, 4, 5)])
def test_blurs_match_jax(shape):
    img = np.random.default_rng(4).normal(size=shape)
    np.testing.assert_allclose(TB.gaussian_blur3(t(img), 1.0).numpy(),
                               np.asarray(jops.gaussian_blur3(jnp.asarray(img), 1.0)), atol=1e-12)
    np.testing.assert_allclose(TB.gaussian_filter(t(img), 1.0).numpy(),
                               np.asarray(jops.gaussian_filter(jnp.asarray(img), 1.0)), atol=1e-12)


def test_sobel_matches_jax():
    from event_based_optical_flow_tpu.ops import sobel as JS

    img = np.random.default_rng(5).normal(size=(2, H, W))
    for a, b in zip(TS.sobel_xy(t(img)), JS.sobel_xy(jnp.asarray(img))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-12)
    np.testing.assert_allclose(TS.sobel_flow(t(img)).numpy(), np.asarray(JS.sobel_flow(jnp.asarray(img))), atol=1e-12)


# ---------------------------------------------------------------- interp
@pytest.mark.parametrize("filter_type,key", [("bilinear", "tile_dense"), ("nearest", "tile_dense_nearest")])
def test_tile_to_dense_golden(filter_type, key):
    out = TI.tile_to_dense_flow(t(GOLDEN["tile_motion"].reshape(-1)), (2, 2), (H, W), (12, 16), (12, 16), (2, 3), filter_type)
    np.testing.assert_allclose(out.numpy(), GOLDEN[key], atol=1e-6)


@pytest.mark.parametrize("pis,ps,shift", [((2, 2), (12, 16), (0, 0)), ((4, 4), (6, 7), (1, 2)), ((8, 8), (3, 4), (0, 1))])
def test_tile_to_dense_matches_jax(pis, ps, shift):
    motion = np.random.default_rng(6).uniform(-20, 20, 2 * pis[0] * pis[1])
    want = jops.tile_to_dense_flow(jnp.asarray(motion), pis, (H, W), ps, ps, shift, "bilinear")
    got = TI.tile_to_dense_flow(t(motion), pis, (H, W), ps, ps, shift, "bilinear")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-12)


@pytest.mark.parametrize("shape", [(2, 2, 2), (2, 4, 4), (2, 8, 8), (2, 3, 5)])
def test_pyramid_resampling_matches_jax(shape):
    m = np.random.default_rng(7).normal(size=shape)
    np.testing.assert_allclose(TI.pyramid_expand(t(m)).numpy(), JI.pyramid_expand(m), atol=1e-12)
    np.testing.assert_allclose(TI.pyramid_reduce(t(m)).numpy(), JI.pyramid_reduce(m), atol=1e-12)


# ----------------------------------------------------------------- costs
def _cost_args(omit):
    iwe, orig = GOLDEN["iwe"], GOLDEN["iwe_blur_torch"]
    return {
        "iwe": iwe, "orig_iwe": orig, "omit_boundary": omit, "forward_iwe": iwe,
        "backward_iwe": orig * 0.7 + iwe * 0.3, "middle_iwe": iwe * 1.1, "flow": GOLDEN["dense"],
    }


@pytest.mark.parametrize("omit", [True, False])
def test_hybrid_costs_golden_and_jax(omit):
    suffix = "omit" if omit else "full"
    arg = _cost_args(omit)
    targ = {k: (t(v) if isinstance(v, np.ndarray) else v) for k, v in arg.items()}
    jarg = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in arg.items()}
    cww = {"multi_focal_normalized_gradient_magnitude": 1.0, "total_variation": 0.01}
    checks = {
        "mf_norm_grad_mag": (TR.MultiFocalNormalizedGradientMagnitude(), JR.MultiFocalNormalizedGradientMagnitude()),
        "total_variation": (TR.TotalVariation(), JR.TotalVariation()),
        "hybrid": (TR.HybridCost("minimize", cww), JR.HybridCost("minimize", cww)),
    }
    for name, (tc, jc) in checks.items():
        got = float(tc.calculate(targ))
        assert got == pytest.approx(float(GOLDEN[f"{name}_{suffix}"]), rel=1e-9), name
        assert got == pytest.approx(float(jc.calculate(jarg)), rel=1e-12), name
    loss, comps = checks["hybrid"][0].calculate_with_components(targ)
    assert set(comps) == set(cww)


@pytest.mark.parametrize("omit", [True, False])
def test_functional_costs_golden(omit):
    suffix = "omit" if omit else "full"
    iwe, orig = t(GOLDEN["iwe"]), t(GOLDEN["iwe_blur_torch"])
    # the fixtures hold minimize-direction values: -GM, 1/ratio
    assert -float(TF.gradient_magnitude(iwe, omit)) == pytest.approx(float(GOLDEN[f"gradient_magnitude_{suffix}"]), rel=1e-9)
    assert 1.0 / float(TF.normalized_gradient_magnitude(iwe, orig, omit)) == pytest.approx(
        float(GOLDEN[f"norm_grad_mag_{suffix}"]), rel=1e-9)
    assert 1.0 / float(TF.normalized_image_variance(iwe, orig, omit)) == pytest.approx(
        float(GOLDEN[f"norm_image_variance_{suffix}"]), rel=1e-9)


def test_batched_gradient_magnitude_and_fwl_variance_match_jax():
    imgs = np.random.default_rng(8).normal(size=(3, 4, 9, 11))
    got = TF.gradient_magnitude(t(imgs), omit_boundary=False).numpy()
    for i in range(3):
        for k in range(4):
            want = float(JF.gradient_magnitude(jnp.asarray(imgs[i, k]), omit_boundary=False))
            assert got[i, k] == pytest.approx(want, rel=1e-12)
    a, b = imgs[0, 0], imgs[1, 1]
    assert float(TF.normalized_image_variance(t(a), t(b), False, ddof=0)) == pytest.approx(
        float(JF.normalized_image_variance(jnp.asarray(a), jnp.asarray(b), False, ddof=0)), rel=1e-12)


def test_nan_to_penalty():
    out = TF.nan_to_penalty(t([1.0, np.nan, np.inf]))
    assert out.tolist() == [1.0, 1e10, np.inf]


# --------------------------------------------------------------- metrics
def test_flow_error_metrics_golden_and_jax():
    got = {k: float(v) for k, v in calculate_flow_error(t(GOLDEN["gt"]), t(GOLDEN["pred"]),
                                                        torch.as_tensor(GOLDEN["emask"])).items()}
    want = calculate_flow_error_numpy(GOLDEN["gt"], GOLDEN["pred"], event_mask=GOLDEN["emask"])
    for k in ("EPE", "1PE", "2PE", "3PE", "5PE", "10PE", "20PE", "AE"):
        assert got[k] == pytest.approx(float(GOLDEN[f"err_{k}"]), rel=1e-6), k
        assert got[k] == pytest.approx(want[k], rel=1e-12), k


# ------------------------------------------------------ host-side layouts
@pytest.mark.parametrize("n,target", [(500, None), (0, 64), (100, 100)])
def test_pad_events_matches_jax(n, target):
    from event_based_optical_flow_tpu.types import pad_events as jax_pad
    from event_based_optical_flow_tpu_torch.types import pad_events

    ev = _events(n)
    got, want = pad_events(ev, target), jax_pad(ev, target)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[1].sum() == n and (got[0][n:, 2] == (ev[:, 2].min() if n else 0.0)).all()


@pytest.mark.parametrize("capacity", [512, 8])
def test_gather_patch_events_matches_jax(capacity):
    """The lattice tiles of every pyramid scale of a 36x44 frame; capacity 8
    oversubscribes every tile (even subsampling)."""
    from event_based_optical_flow_tpu.solver import patch_base as JP
    from event_based_optical_flow_tpu.solver import sampling as JSm
    from event_based_optical_flow_tpu_torch.solver import patch_base as TP
    from event_based_optical_flow_tpu_torch.solver import sampling as TSm

    ev = _events(3000, seed=4, h=36, w=44)
    for s in (1, 2, 3):
        size = (32 // 2**s, 40 // 2**s)
        jpatches, jshape = JP.prepare_patch((32, 40), size, size)
        tpatches, tshape = TP.prepare_patch((32, 40), size, size)
        assert tshape == jshape
        want = JSm.gather_patch_events(ev, jpatches, capacity)
        got = TSm.gather_patch_events(ev, tpatches, capacity)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="lattice"):
        TSm.gather_patch_events(ev, {0: tpatches[0], 1: tpatches[0]}, capacity)
