"""The analytic Hessian-vector product of the port against the JAX
package, in float64, JAX's Pallas kernels in interpret mode
(``use_bf16=False``, as ``tests/test_pallas_and_sharding.py`` runs them).

* K3 (``fused_iwe_jvp``) and K4 (``fused_iwe_hvp_bwd``): the plain versions
  against ``fused_multi_iwe_banded_jvp`` / ``_hvp_bwd`` on band-packed
  events, both ways of ``emit_value`` and ``term_a``;
* the objective's staged and unstaged HVP against JAX's
  ``build_objective_banded_hvp_staged(precomputed_orig=True)`` with
  ``iwe_backend: pallas``, Gauss-Newton and full;
* the full-Hessian HVP against ``torch.func.jvp`` of the gradient of the
  port's plain objective (the port's counterpart of
  ``test_v10_analytic_hvp_matches_autodiff_oracle``);
* ``objective_supports_analytic_hvp`` and the ``hvp_mode`` routing table
  (``_want_analytic``) against JAX's, for all six modes x warm x finest.

Tolerance 1e-9 x the largest value throughout: float64 sums of the same
terms in another order.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from event_based_optical_flow_tpu.ops import pallas_objective_banded as PB
from event_based_optical_flow_tpu.solver import objective as JO
from event_based_optical_flow_tpu.solver.patch_base import PatchContrastMaximization as JaxPatch
from event_based_optical_flow_tpu.types import pad_events
from event_based_optical_flow_tpu_torch.ops import fused_iwe as FI
from event_based_optical_flow_tpu_torch.solver import objective as TO
from event_based_optical_flow_tpu_torch.solver.patch_base import HVP_MODES
from event_based_optical_flow_tpu_torch.solver.patch_base import PatchContrastMaximization as TorchPatch
from test_torch_fused_iwe import H, OFFSETS, W, _inputs
from test_torch_newton_cg import _cmax_problem

RTOL = 1e-9  # x the largest value


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _close(got, want, least=0.1):
    """got == want to RTOL x max|want|; max|want| >= least (not vacuous)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert scale >= least
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * scale)


def _second_order_inputs():
    """Band-packed events for JAX, the same events for the port, and a
    flow, tangent flow and two cotangents."""
    padded, wgt, dtf, flow, _ = _inputs()
    rng = np.random.default_rng(9)
    dflow = rng.normal(0, 3.0, (2, H, W))
    g1, g2 = rng.normal(size=(2, len(OFFSETS), H, W))
    packed = [jnp.asarray(a) for a in PB.pack_events_by_band(padded, wgt, dtf, H)]
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64)
    events = (t(padded[:, 0]), t(padded[:, 1]), t(dtf), t(wgt))
    return packed, events, flow, dflow, g1, g2, t


@pytest.mark.parametrize("emit_value", [True, False])
def test_jvp_plain_version_matches_pallas(emit_value):
    packed, events, flow, dflow, _, _, t = _second_order_inputs()
    want = PB.fused_multi_iwe_banded_jvp(jnp.asarray(flow), jnp.asarray(dflow), *packed, (H, W), OFFSETS,
                                         eps=1e-6, use_bf16=False, emit_value=emit_value)
    got = FI.fused_iwe_jvp(t(flow), t(dflow), *events, OFFSETS, emit_value)
    if emit_value:
        (img_j, tan_j), (img_t, tan_t) = want, got
        _close(img_t.numpy(), img_j)
        # the value half is the forward's own images
        np.testing.assert_array_equal(img_t.numpy(), FI.fused_iwe(t(flow), *events, OFFSETS, False).numpy())
    else:
        tan_j, tan_t = want, got
    _close(tan_t.numpy(), tan_j)


@pytest.mark.parametrize("form", ["dense", "voxel"])
def test_jvp_exact_model_matches_pallas(form):
    """The exact model of K3's (K6's) bits against the Pallas tangent
    kernel: to 1e-9 x the largest value (the model's fixed-point unit is
    ~2^-47 of it here, far below)."""
    if form == "dense":
        packed, events, flow, dflow, _, _, t = _second_order_inputs()
        want = PB.fused_multi_iwe_banded_jvp(jnp.asarray(flow), jnp.asarray(dflow), *packed, (H, W), OFFSETS,
                                             eps=1e-6, use_bf16=False, emit_value=False)
        bins = None
    else:
        packed, events, bins, flow, dflow, _, _, t = _voxel_second_order_inputs()
        want = PB.fused_multi_iwe_banded_voxel_jvp(jnp.asarray(flow), jnp.asarray(dflow), *packed, (H, W),
                                                   OFFSETS, eps=1e-6, use_bf16=False, emit_value=False)
    (s,) = FI._tangent_exponents(t(dflow), *events, OFFSETS, bins, None)
    assert 30 < s < 60
    _close(FI.fused_iwe_jvp_fixed_reference(t(flow), t(dflow), *events, OFFSETS, False, bins=bins).numpy(), want)


def test_cpu_tensors_take_the_plain_versions():
    """On CPU tensors K3/K4's wrappers run the plain versions: no launch
    is counted."""
    _, events, flow, dflow, g1, g2, t = _second_order_inputs()
    before = FI.launch_counts()
    FI.fused_iwe_jvp(t(flow), t(dflow), *events, OFFSETS, True)
    FI.fused_iwe_hvp_bwd(t(flow), t(dflow), t(g1), t(g2), *events, OFFSETS, True)
    assert FI.launch_counts() == before


@pytest.mark.parametrize("term_a", [False, True])
def test_hvp_bwd_plain_version_matches_pallas(term_a):
    packed, events, flow, dflow, g1, g2, t = _second_order_inputs()
    want = PB.fused_multi_iwe_banded_hvp_bwd(
        jnp.asarray(flow), jnp.asarray(dflow), jnp.asarray(g1), jnp.asarray(g2), *packed, (H, W),
        OFFSETS, eps=1e-6, use_bf16=False, term_a=term_a)
    got = FI.fused_iwe_hvp_bwd(t(flow), t(dflow), t(g1), t(g2), *events, OFFSETS, term_a)
    _close(got.numpy(), want)
    if not term_a:  # term B alone is the backward against g2
        fl = t(flow).requires_grad_(True)
        (vjp,) = torch.autograd.grad(FI.fused_iwe(fl, *events, OFFSETS, False), fl, t(g2))
        np.testing.assert_array_equal(got.numpy(), vjp.numpy())


def _hvp_problem():
    ev, jspec, tspec, motion = _cmax_problem()
    h, w = jspec.image_shape
    padded, wgt = pad_events(ev)
    tcol = padded[:, 2]
    t_min, t_max = tcol[wgt > 0].min(), tcol[wgt > 0].max()
    packed = PB.pack_events_dense(padded, wgt, (tcol - t_min) / (t_max - t_min), h, w)
    jargs = tuple(jnp.asarray(a) for a in packed) + (jnp.asarray(t_max - t_min),)
    frame = TO.FrameEvents.from_numpy(ev, "cpu", torch.float64)
    p = np.random.default_rng(21).normal(0, 1, motion.shape)
    return jspec, tspec, jargs, frame, motion, p


@pytest.mark.parametrize("gauss_newton", [True, False])
def test_staged_and_unstaged_hvp_match_jax(gauss_newton):
    jspec, tspec, jargs, frame, motion, p = _hvp_problem()
    jorig = JO.build_orig_iwe_banded(jspec)(*jargs)
    prep, hvp = JO.build_objective_banded_hvp_staged(jspec, precomputed_orig=True, gauss_newton=gauss_newton)
    m, pj = jnp.asarray(motion), jnp.asarray(p)
    want = hvp(prep(m, jorig, *jargs), m, pj, jorig, *jargs)

    torig = TO.build_orig_iwe(tspec)(frame)
    mt, pt = torch.as_tensor(motion), torch.as_tensor(p)
    tprep, thvp = TO.build_objective_hvp_staged(tspec, gauss_newton)
    staged = thvp(tprep(mt, torig, frame), mt, pt, torig, frame)
    unstaged = TO.build_objective_hvp(tspec, gauss_newton)(mt, pt, torig, frame)
    _close(staged.numpy(), want, least=1e-3)
    np.testing.assert_array_equal(staged.numpy(), unstaged.numpy())


def test_full_hvp_matches_autodiff_of_plain_objective():
    """Full Hessian (term A on): the analytic assembly equals forward-mode
    autodiff of the plain objective's gradient; Gauss-Newton differs from
    it by term A alone."""
    _, tspec, _, frame, motion, p = _hvp_problem()
    orig = TO.build_orig_iwe(tspec)(frame)
    mt, pt = torch.as_tensor(motion), torch.as_tensor(p)
    obj = TO.build_objective(tspec)
    _, oracle = torch.func.jvp(torch.func.grad(lambda m: obj(m, orig, frame)[0]), (mt,), (pt,))
    full = TO.build_objective_hvp(tspec, gauss_newton=False)(mt, pt, orig, frame)
    _close(full.numpy(), oracle.numpy(), least=1e-3)
    gn = TO.build_objective_hvp(tspec, gauss_newton=True)(mt, pt, orig, frame)
    assert torch.isfinite(gn).all() and not torch.allclose(gn, full)


@pytest.mark.parametrize("mode", HVP_MODES + ("surprise",))
def test_routing_table_matches_jax(mode):
    jspec, tspec, _, _, _, _ = _hvp_problem()
    for gn in (True, False):
        assert TO.objective_supports_analytic_hvp(tspec, gn) == JO.objective_supports_analytic_hvp(jspec, gn)
    state = SimpleNamespace(opt_config={"hvp_mode": mode})
    for warm in (False, True):
        for finest in (False, True):
            assert (TorchPatch._want_analytic(state, warm, finest)
                    == JaxPatch._want_analytic(state, warm, finest)), (mode, warm, finest)


# --- time-aware: K6 and the voxel objective's Gauss-Newton HVP -------------

from test_torch_fused_iwe import T_BINS, _jax_voxel_packed, _voxel_inputs  # noqa: E402


def _voxel_second_order_inputs():
    padded, wgt, dtf, bins, voxel, _ = _voxel_inputs()
    rng = np.random.default_rng(19)
    dvoxel = rng.normal(0, 3.0, voxel.shape)
    g1, g2 = rng.normal(size=(2, len(OFFSETS), H, W))
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64)
    events = (t(padded[:, 0]), t(padded[:, 1]), t(dtf), t(wgt))
    return _jax_voxel_packed(padded, wgt, dtf), events, torch.as_tensor(bins), voxel, dvoxel, g1, g2, t


@pytest.mark.parametrize("emit_value", [True, False])
def test_voxel_jvp_plain_version_matches_pallas(emit_value):
    """K6's tangent (``fused_iwe_jvp`` with ``bins``) against
    ``fused_multi_iwe_banded_voxel_jvp``."""
    packed, events, bins, voxel, dvoxel, _, _, t = _voxel_second_order_inputs()
    want = PB.fused_multi_iwe_banded_voxel_jvp(jnp.asarray(voxel), jnp.asarray(dvoxel), *packed, (H, W),
                                               OFFSETS, eps=1e-6, use_bf16=False, emit_value=emit_value)
    got = FI.fused_iwe_jvp(t(voxel), t(dvoxel), *events, OFFSETS, emit_value, bins=bins)
    if emit_value:
        (img_j, tan_j), (img_t, tan_t) = want, got
        _close(img_t.numpy(), img_j)
        np.testing.assert_array_equal(img_t.numpy(),
                                      FI.fused_iwe(t(voxel), *events, OFFSETS, False, bins=bins).numpy())
    else:
        tan_j, tan_t = want, got
    _close(tan_t.numpy(), tan_j)


@pytest.mark.parametrize("term_a", [False, True])
def test_voxel_hvp_bwd_plain_version_matches_pallas(term_a):
    """K6's HVP backward (per bin ``[T, 2, H, W]``) against
    ``fused_multi_iwe_banded_voxel_hvp_bwd``; term B alone is K5's backward
    against g2."""
    packed, events, bins, voxel, dvoxel, g1, g2, t = _voxel_second_order_inputs()
    want = PB.fused_multi_iwe_banded_voxel_hvp_bwd(
        jnp.asarray(voxel), jnp.asarray(dvoxel), jnp.asarray(g1), jnp.asarray(g2), *packed, (H, W), OFFSETS,
        eps=1e-6, use_bf16=False, term_a=term_a)
    got = FI.fused_iwe_hvp_bwd(t(voxel), t(dvoxel), t(g1), t(g2), *events, OFFSETS, term_a, bins=bins)
    assert got.shape == (T_BINS, 2, H, W)
    _close(got.numpy(), want)
    if not term_a:
        vt = t(voxel).requires_grad_(True)
        (vjp,) = torch.autograd.grad(FI.fused_iwe(vt, *events, OFFSETS, False, bins=bins), vt, t(g2))
        np.testing.assert_array_equal(got.numpy(), vjp.numpy())


def _time_aware_problem(scheme="burgers", loc="middle"):
    """``_hvp_problem`` with the voxel objective (3 bins), the JAX side
    packed by (bin, band)."""
    import dataclasses

    ev, jspec, tspec, motion = _cmax_problem()
    ta = dict(time_aware=True, time_bin=T_BINS, flow_interpolation=scheme, t0_location=loc)
    jspec, tspec = dataclasses.replace(jspec, **ta), dataclasses.replace(tspec, **ta)
    h, _ = jspec.image_shape
    padded, wgt = pad_events(ev)
    tcol = padded[:, 2]
    t_min, t_max = tcol[wgt > 0].min(), tcol[wgt > 0].max()
    packed = PB.pack_events_by_band_bin(padded, wgt, (tcol - t_min) / (t_max - t_min), h, T_BINS)
    jargs = tuple(jnp.asarray(a) for a in packed) + (jnp.asarray(t_max - t_min),)
    frame = TO.FrameEvents.from_numpy(ev, "cpu", torch.float64, time_bin=T_BINS)
    p = np.random.default_rng(21).normal(0, 1, motion.shape)
    return jspec, tspec, jargs, frame, motion, p


@pytest.mark.parametrize("scheme,loc", [("burgers", "middle"), ("upwind", "first")])
def test_time_aware_objective_matches_jax(scheme, loc):
    """The voxel objective (the Burgers / upwind chain, K5, blur, hybrid
    cost) and its gradient through the chain against
    ``build_objective_banded`` with a time-aware spec; the orig IWE is the
    zero voxel's."""
    jspec, tspec, jargs, frame, motion, _ = _time_aware_problem(scheme, loc)
    jorig = JO.build_orig_iwe_banded(jspec)(*jargs)
    jobj = JO.build_objective_banded(jspec, precomputed_orig=True)
    lj, gj = jax.value_and_grad(lambda m: jobj(m, jorig, *jargs)[0])(jnp.asarray(motion))
    torig = TO.build_orig_iwe(tspec)(frame)
    np.testing.assert_allclose(torig.numpy(), np.asarray(jorig), rtol=0, atol=1e-12)
    m = torch.as_tensor(motion).requires_grad_(True)
    loss = TO.build_objective(tspec)(m, torig, frame)[0]
    (gt,) = torch.autograd.grad(loss, m)
    assert loss.item() == pytest.approx(float(lj), rel=1e-12)
    _close(gt.numpy(), gj, least=1e-2)


def test_time_aware_staged_hvp_matches_jax():
    """The voxel objective's staged Gauss-Newton HVP (K5 values, the
    chain's jvp, K6's tangent, the cost's jvp-of-grad, K6's HVP backward,
    the chain's vjp) against ``build_objective_banded_hvp_staged``; the
    unstaged form gives the same bits."""
    jspec, tspec, jargs, frame, motion, p = _time_aware_problem()
    jorig = JO.build_orig_iwe_banded(jspec)(*jargs)
    prep, hvp = JO.build_objective_banded_hvp_staged(jspec, precomputed_orig=True, gauss_newton=True)
    m, pj = jnp.asarray(motion), jnp.asarray(p)
    want = hvp(prep(m, jorig, *jargs), m, pj, jorig, *jargs)
    torig = TO.build_orig_iwe(tspec)(frame)
    mt, pt = torch.as_tensor(motion), torch.as_tensor(p)
    tprep, thvp = TO.build_objective_hvp_staged(tspec, True)
    staged = thvp(tprep(mt, torig, frame), mt, pt, torig, frame)
    _close(staged.numpy(), want, least=1e-3)
    np.testing.assert_array_equal(staged.numpy(), TO.build_objective_hvp(tspec, True)(mt, pt, torig, frame).numpy())


def test_time_aware_routing_matches_jax():
    """A time-aware objective takes the analytic HVP in its Gauss-Newton
    form only, in both packages; it refuses events without bins."""
    jspec, tspec, _, _, _, _ = _time_aware_problem()
    for gn in (True, False):
        assert TO.objective_supports_analytic_hvp(tspec, gn) == JO.objective_supports_analytic_hvp(jspec, gn) == gn
    ev, _, _, motion = _cmax_problem()
    dense_frame = TO.FrameEvents.from_numpy(ev, "cpu", torch.float64)
    with pytest.raises(ValueError, match="time bins"):
        TO.build_objective(tspec)(torch.as_tensor(motion), None, dense_frame)
