"""The port's solvers on a ``parallel:`` mesh (the CPU repeated, as the JAX
tests' 8 virtual devices), against the port's single-device solves and the
JAX package's meshed ones (``iwe_backend: pallas`` in interpret mode,
float64, JAX's init-sweep draws injected as ``tests/test_torch_pyramid.py``
injects them):

* the pyramid with ``parallel: {data: 1, event: 2}``: every scale's Newton
  solve takes the event-sharded frame; its per-scale motions equal the
  port's single-device solve (to 1e-10: the plain route votes the whole
  frame, as the card's integer reduction keeps the single-device bits) and
  the JAX package's meshed solve to 1e-6;
* the mesh's rules (``SolverBase._setup_parallel``): no block or 1x1 gives
  no mesh, a block beyond the visible CUDA devices raises the JAX
  package's ``ValueError``, the unfused route and the host optimizers run
  on one device with a warning, a prebuilt mesh replaces the block.

The fleet's and the multi-stream server's data mesh are in
``tests/test_torch_parallel_fleet.py``.
"""

import copy
import logging

import numpy as np
import pytest
import torch

from event_based_optical_flow_tpu import solver as jsolver
from event_based_optical_flow_tpu_torch import main as port_main
from event_based_optical_flow_tpu_torch import solver as tsolver
from event_based_optical_flow_tpu_torch.parallel import make_mesh
from event_based_optical_flow_tpu_torch.solver.objective import ShardedFrame
from test_torch_pyramid import OPTIMIZER, SOLVER, H, W, JaxDraws, _record, _threads, scene  # noqa: F401

CPU = torch.device("cpu")
MESH = {"data": 1, "event": 2}


def _port(slv, opt, draws=True, **kw):
    return tsolver.collections[slv["method"]]((H, W), {}, slv, opt, {}, device="cpu",
                                              candidates_fn=JaxDraws() if draws else None, **kw)


def _newton_frames(solver):
    """Record the frame each ``_run_newton`` call takes."""
    frames, run = [], solver._run_newton

    def wrapped(spec, x0, frame, *a, **k):
        frames.append(frame)
        return run(spec, x0, frame, *a, **k)

    solver._run_newton = wrapped
    return frames


def test_pyramid_event_mesh_matches_single_device_and_jax(scene):
    """``parallel: {data: 1, event: 2}`` on the MVSEC solver block: each
    scale's Newton solve takes the frame cut over two devices (the loop:
    no chain on a mesh), the per-scale motions are the single-device
    solve's to 1e-10 and the JAX package's meshed solve's to 1e-6."""
    events, gt_flow, dt = scene
    meshed = dict(SOLVER, parallel=MESH)
    opt = dict(OPTIMIZER, chain=True)  # the port's single device chained, its mesh the loop; JAX's loop
    sj = jsolver.collections[SOLVER["method"]]((H, W), {}, meshed, OPTIMIZER, {}, None)
    assert sj.n_event_shards == 2
    got_j, got_m, got_s = [], [], []
    _record(sj, ["_run_newton_device", "_run_fused_scale_device"], got_j, np.asarray)
    single, mesh = _port(SOLVER, opt), _port(meshed, opt)
    assert mesh.mesh.shape == MESH and mesh.mesh.lead == CPU and single.mesh is None
    frames = _newton_frames(mesh)
    _record(single, ["_run_newton"], got_s, lambda out: out[0].numpy().copy())
    _record(mesh, ["_run_newton"], got_m, lambda out: out[0].numpy().copy())
    bj, bs, bm = sj.optimize(events), single.optimize(events), mesh.optimize(events)
    assert len(got_j) == len(got_m) == len(got_s) == 2
    assert all(isinstance(f, ShardedFrame) and len(f.shards) == 2 for f in frames)
    assert mesh.last_frame_stats["chain"] is False and single.last_frame_stats["chain"] is True
    for a, b, c in zip(got_j, got_m, got_s):
        np.testing.assert_allclose(b.reshape(-1), c.reshape(-1), rtol=0, atol=1e-10)
        np.testing.assert_allclose(b.reshape(-1), np.asarray(a).reshape(-1), rtol=0, atol=1e-6)
    for s in bs:
        np.testing.assert_allclose(bm[s].numpy(), bs[s].numpy(), rtol=0, atol=1e-10)
        np.testing.assert_allclose(bm[s].numpy(), np.asarray(bj[s]), rtol=0, atol=1e-6)
    em, ej = mesh.calculate_flow_error(bm, gt_flow, dt, events), sj.calculate_flow_error(bj, gt_flow, dt, events)
    for k in ("EPE", "AE", "GT_FWL", "PRED_FWL"):
        assert em[k] == pytest.approx(ej[k], rel=1e-6, abs=1e-9), k


@pytest.mark.parametrize("variant", ["dsec", "time_aware", "lbfgs", "warm_finest"])
def test_pyramid_event_mesh_variants_keep_the_single_device_result(scene, variant):
    """The DSEC solver block (the analytic HVP on the finest scale, the
    coarse scales on the stride-4 subsample, each sharded), a time-aware
    block (K5/K6 keyed by (bin, pixel)), the device L-BFGS and a warm
    finest-only frame: on ``event: 3`` the port's per-scale motions are its
    single-device solve's to 1e-10."""
    events, _, _ = scene
    slv, opt = dict(SOLVER), dict(OPTIMIZER)
    if variant == "dsec":
        opt.update(hvp_mode="analytic", fd_polish=2, cg_maxiter=8, coarse_event_fraction=0.25)
    elif variant == "time_aware":
        slv.update(time_aware=True, time_bin=3, flow_interpolation="burgers", t0_flow_location="middle")
    elif variant == "lbfgs":
        opt.update(device_solver="lbfgs", max_iter=4)
    else:
        opt.update(chain=True, warm_finest_only=True)
    results = []
    for parallel in (None, {"data": 1, "event": 3}):
        solver = _port(dict(slv, parallel=parallel) if parallel else slv, opt)
        frames = _newton_frames(solver)
        if variant == "warm_finest":
            solver.set_previous_frame_best_estimation({1: np.full((2, 2, 2), 3.0), 2: np.full((2, 4, 4), -2.0)})
        best = solver.optimize(events)
        assert all(isinstance(f, ShardedFrame) == bool(parallel) for f in frames) and frames
        results.append((best, solver.last_frame_stats))
    (bs, ss), (bm, sm) = results
    assert sm["iters"] == ss["iters"] and sm["hvp"] == ss["hvp"] and sm["events"] == ss["events"]
    for s in bs:
        np.testing.assert_allclose(bm[s].numpy(), bs[s].numpy(), rtol=0, atol=1e-10)
    if variant == "warm_finest":
        assert sm["warm_finest"] and not sm["chain"]


def test_mesh_rules_as_jax(monkeypatch, caplog):
    """No block, or 1x1, leaves the solver without a mesh; on CUDA a block
    beyond the visible devices raises the JAX package's ``ValueError``
    (both counts; the JAX solver's on its 8 devices alike); the unfused
    route and the host optimizers solve on one device with a warning; a
    prebuilt mesh (``main.build(..., mesh=)``) replaces the block."""
    for parallel in (None, {}, {"data": 1, "event": 1}):
        solver = _port(dict(SOLVER, parallel=parallel), OPTIMIZER, draws=False)
        assert solver.mesh is None and solver.n_event_shards == 1
    with pytest.raises(ValueError, match=r"data=4 x event=4 = 16 devices but only 8 are visible"):
        jsolver.collections[SOLVER["method"]]((H, W), {}, dict(SOLVER, parallel={"data": 4, "event": 4}), OPTIMIZER,
                                              {}, None)
    stub = object.__new__(tsolver.collections[SOLVER["method"]])
    stub.device = torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match=r"data=1 x event=2 = 2 devices but only 1 are visible"):
        stub._setup_parallel(MESH)
    monkeypatch.undo()
    with caplog.at_level(logging.WARNING):
        padded = _port(dict(SOLVER, outer_padding=2, parallel=MESH), OPTIMIZER, draws=False)
        assert padded.mesh is not None and not padded._shards_events()
    assert "runs single-device" in caplog.text
    caplog.clear()
    host = _port(dict(SOLVER, parallel=MESH), dict(OPTIMIZER, method="BFGS", max_iter=1), draws=False)
    frames = _newton_frames(host)
    with caplog.at_level(logging.WARNING):
        host._optimize_scales(np.asarray([[1.0, 2.0, 0.0, 1.0], [3.0, 4.0, 0.01, 0.0]] * 300), chain=False)
    assert "solves from the host" in caplog.text and not frames
    config = {"data": {"dataset": "synthetic", "sequence": "x", "height": H, "width": W},
              "solver": dict(SOLVER, parallel=MESH), "optimizer": OPTIMIZER, "output": {}}
    given = make_mesh(3, data=1, event=3, devices=[CPU] * 3)
    _, solver = port_main.build(copy.deepcopy(config), "cpu", mesh=given)
    assert solver.mesh is given and solver.n_event_shards == 3
    config["parallel"] = {"data": 2, "event": 1}
    _, solver = port_main.build(config, "cpu")
    assert config["solver"]["parallel"] == {"data": 2, "event": 1} and solver.mesh.shape == {"data": 2, "event": 1}
