"""The cost registry's five contrast costs beside the multi-focal gradient
cost and TV (``image_variance``, ``gradient_magnitude``,
``normalized_image_variance``, ``normalized_gradient_magnitude``,
``multi_focal_normalized_image_variance``) against the JAX package's, in
float64:

* each registry class, in every direction it has (minimize, maximize,
  natural, the reference's quirks included), and the two new functional
  forms, on random images to 1e-12;
* each as the objective's cost, value and gradient, on tiles and on a
  global model (4-param-similarity) against JAX's banded objective
  (``iwe_backend: pallas``, interpret mode) to 1e-9;
* a config that switches ``solver.cost`` (or a hybrid term) to each
  validates in the port with the JAX package's warnings.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from event_based_optical_flow_tpu import costs as jcosts
from event_based_optical_flow_tpu.costs import functional as JF
from event_based_optical_flow_tpu.solver import objective as JO
from event_based_optical_flow_tpu.types import pad_events
from event_based_optical_flow_tpu.ops import pallas_objective_banded as PB
from event_based_optical_flow_tpu_torch import costs as tcosts
from event_based_optical_flow_tpu_torch.costs import functional as TF
from event_based_optical_flow_tpu_torch.solver import objective as TO
from test_torch_cli import REPO
from test_torch_global import _objective_problem
from test_torch_newton_cg import _cmax_problem

NEW_COSTS = ("image_variance", "gradient_magnitude", "normalized_image_variance", "normalized_gradient_magnitude",
             "multi_focal_normalized_image_variance")


def _images(seed=0, h=18, w=22):
    rng = np.random.default_rng(seed)
    names = ("iwe", "orig_iwe", "forward_iwe", "backward_iwe", "middle_iwe")
    return {k: rng.gamma(1.5, 1.0, (h, w)) for k in names}


def test_registry_lists_the_jax_costs():
    assert sorted(tcosts.functions) == sorted(jcosts.functions)
    for name in NEW_COSTS:
        assert tcosts.functions[name].required_keys == jcosts.functions[name].required_keys


@pytest.mark.parametrize("direction", ["minimize", "maximize", "natural"])
@pytest.mark.parametrize("name", NEW_COSTS)
def test_cost_matches_jax(name, direction):
    imgs = _images()
    for omit, middle in ((True, True), (False, True), (True, False)):
        arg = {"omit_boundary": omit, **imgs}
        if not middle:
            arg.pop("middle_iwe")
        got = tcosts.functions[name](direction=direction).calculate(
            {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v for k, v in arg.items()})
        want = jcosts.functions[name](direction=direction).calculate(
            {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in arg.items()})
        assert float(got) == pytest.approx(float(want), rel=1e-12, abs=0), (omit, middle)


@pytest.mark.parametrize("ddof", [0, 1])
def test_new_functional_forms_match_jax(ddof):
    imgs = _images(1)
    t = {k: torch.as_tensor(v) for k, v in imgs.items()}
    j = {k: jnp.asarray(v) for k, v in imgs.items()}
    for omit in (True, False):
        assert float(TF.image_variance(t["iwe"], omit, ddof)) == pytest.approx(
            float(JF.image_variance(j["iwe"], omit, ddof)), rel=1e-12)
        for mid in ("middle_iwe", None):
            got = TF.multi_focal_normalized_image_variance(t["orig_iwe"], t["forward_iwe"], t["backward_iwe"],
                                                           t[mid] if mid else None, omit, ddof)
            want = JF.multi_focal_normalized_image_variance(j["orig_iwe"], j["forward_iwe"], j["backward_iwe"],
                                                            j[mid] if mid else None, omit, ddof)
            assert float(got) == pytest.approx(float(want), rel=1e-12)
    with pytest.raises(ValueError, match="direction"):
        tcosts.functions["image_variance"](direction="sideways")


def _value_and_grad(jspec, tspec, jargs, frame, motion):
    """(JAX's loss and gradient, the port's) of one cost's objective."""
    hoist = "orig_iwe" in JO.make_cost(jspec).required_keys
    jobj = JO.build_objective_banded(jspec, precomputed_orig=hoist)
    pre = (JO.build_orig_iwe_banded(jspec)(*jargs),) if hoist else ()
    lj, gj = jax.value_and_grad(lambda m: jobj(m, *pre, *jargs)[0])(jnp.asarray(motion))
    m = torch.as_tensor(motion).requires_grad_(True)
    loss = TO.build_objective(tspec)(m, TO.build_orig_iwe(tspec)(frame), frame)[0]
    (gt,) = torch.autograd.grad(loss, m)
    return (float(lj), np.asarray(gj)), (loss.item(), gt.numpy())


def _assert_close(got, want):
    (lt, gt), (lj, gj) = got, want
    assert lt == pytest.approx(lj, rel=1e-9)
    scale = np.abs(gj).max()
    assert scale > 0
    np.testing.assert_allclose(gt, gj, rtol=0, atol=1e-9 * scale)


@pytest.mark.parametrize("name", NEW_COSTS)
def test_cost_through_the_tile_objective_matches_jax(name):
    ev, jspec, tspec, motion = _cmax_problem()
    jspec = jspec.__class__(**{**jspec.__dict__, "cost_name": name, "cost_with_weight": None})
    tspec = tspec.__class__(**{**tspec.__dict__, "cost_name": name, "cost_with_weight": None})
    h, w = jspec.image_shape
    padded, wgt = pad_events(ev)
    tcol = padded[:, 2]
    t_min, t_max = tcol[wgt > 0].min(), tcol[wgt > 0].max()
    packed = PB.pack_events_dense(padded, wgt, (tcol - t_min) / (t_max - t_min), h, w)
    jargs = tuple(jnp.asarray(a) for a in packed) + (jnp.asarray(t_max - t_min),)
    frame = TO.FrameEvents.from_numpy(ev, "cpu", torch.float64)
    want, got = _value_and_grad(jspec, tspec, jargs, frame, motion)
    _assert_close(got, want)


@pytest.mark.parametrize("name", NEW_COSTS)
def test_cost_through_a_global_objective_matches_jax(name):
    sj, st, jargs, frame, motion, _ = _objective_problem("4-param-similarity", cost=name)
    jspec, tspec = sj._current_spec(), st._current_spec()
    assert tspec.cost_name == jspec.cost_name == name
    want, got = _value_and_grad(jspec, tspec, jargs, frame, motion)
    _assert_close(got, want)


@pytest.mark.parametrize("name", NEW_COSTS)
def test_config_switching_the_cost_validates_as_jax(name):
    from event_based_optical_flow_tpu.utils import validate_config as jax_validate
    from event_based_optical_flow_tpu_torch.utils import validate_config

    for cfg_name in ("synthetic_quickstart.yaml", "synthetic_rotation_global.yaml"):
        config = yaml.safe_load((REPO / "configs" / cfg_name).read_text())
        single = {**config, "solver": {**config["solver"], "cost": name}}
        single["solver"].pop("cost_with_weight", None)
        assert validate_config(single) == jax_validate(single) == []
        hybrid = {**config, "solver": {**config["solver"], "cost": "hybrid",
                                       "cost_with_weight": {name: 1.0, "multi_focal_normalized_gradient_magnitude": 0.5}}}
        assert validate_config(hybrid) == jax_validate(hybrid) == []
