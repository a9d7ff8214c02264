"""The fleet's data mesh (``FleetPyramidalSolver`` with ``parallel:``, the
CPU repeated as the JAX tests' 8 virtual devices) and the multi-stream
server's (``MultiStreamFlowEstimator(parallel_config=)``), against the JAX
package's meshed fleet chain (``shard_map`` over "data", ``iwe_backend:
pallas`` in interpret mode, float64, Newton budgets of 2) with JAX's draws
injected (``ChainDraws``), and against the port's single-device fleet:

* a random-start batch of 3 on ``data: 2`` pads to 4 with its last frame;
  the coarsest starts are the padded batch's draws in frame order, shard d
  takes its slice, and each finer scale's sweep draw (at a shard's patch
  count) serves both shards, as JAX's replicated key does: every frame to
  1e-6 of JAX's, over two batches;
* on the chain each shard's frames are the bits of the port's
  single-device chain of its half from the same starts and draws; the loop
  (``optimizer.chain: false``) is not sharded, as in the JAX package: its
  padded batch's bits;
* the multi-stream server's batching rule and errors, and two pushes of 3
  streams against JAX's meshed server to 1e-6.
"""

import logging

import numpy as np
import pytest
import torch

from event_based_optical_flow_tpu import solver as jsolver
from event_based_optical_flow_tpu import streaming as JSTREAM
from event_based_optical_flow_tpu_torch import solver as tsolver
from event_based_optical_flow_tpu_torch import streaming as TSTREAM
from test_torch_fleet_chain import ChainDraws
from test_torch_pyramid import OPTIMIZER, H, W, _threads, scene  # noqa: F401

CPU = torch.device("cpu")
FLEET_SOLVER = {
    "method": "fleet_pyramidal_patch_contrast_maximization", "time_aware": False,
    "patch": {"initialize": "random", "scale": 3, "crop_height": 32, "crop_width": 40, "filter_type": "bilinear"},
    "motion_model": "2d-translation", "warp_direction": "first", "parameters": ["trans_x", "trans_y"],
    "cost": "hybrid", "outer_padding": 0,
    "cost_with_weight": {"multi_focal_normalized_gradient_magnitude": 1.0, "total_variation": 0.01},
    "iwe": {"method": "bilinear_vote", "blur_sigma": 1}, "iwe_backend": "pallas", "precision": "64",
}


def _fleet_windows(scene):
    events = scene[0]
    return [np.ascontiguousarray(events[i::3][:900]) for i in range(3)]


def _fleet(parallel=None, **opt):
    slv = dict(FLEET_SOLVER, parallel=parallel) if parallel else FLEET_SOLVER
    return tsolver.collections[slv["method"]]((H, W), {}, slv, dict(OPTIMIZER, **opt), {}, device="cpu")


def test_fleet_data_mesh_matches_jax(scene):
    """Two cold batches of 3 frames on ``data: 2`` (the second starts where
    the first left both generators): every frame's per-scale motions are
    the JAX package's meshed fleet's to 1e-6, with one sweep draw per finer
    scale at a shard's 2 frames of patches."""
    frames = _fleet_windows(scene)
    slv, opt = dict(FLEET_SOLVER, parallel={"data": 2}), dict(OPTIMIZER, chain=True)
    sj = jsolver.collections[slv["method"]]((H, W), {}, slv, opt, {}, None)
    draws = ChainDraws(2)
    st = tsolver.collections[slv["method"]]((H, W), {}, slv, opt, {}, device="cpu", candidates_fn=draws)
    assert sj.n_data_shards == st.n_data_shards == 2
    for batch in range(2):
        bj, bt = sj.optimize_batch(frames), st.optimize_batch(frames)
        assert len(bj) == len(bt) == 3 and len(draws.calls) == batch + 1  # one finer scale
        for fj, ft in zip(bj, bt):
            assert sorted(fj) == sorted(ft)
            for s in fj:
                np.testing.assert_allclose(ft[s].numpy(), np.asarray(fj[s]), rtol=0, atol=1e-6)


@pytest.mark.parametrize("chain", [True, False])
def test_fleet_data_mesh_frames_are_their_halves_bits(scene, chain, caplog):
    """The port's own draws, B = 3 on ``data: 2``.  Chained: shard d's
    frames (and per-scale losses, the padding copy's dropped) are the bits
    of a single-device chain of its half [0, 1] / [2, 2] whose numpy
    generator first skips the starts of the shards before it (the sweep
    draws of both are the first of a fresh generator); a per-frame warm
    list splits with the batch, and the warm batch is the halves' warm
    batch.  The loop is the single-device loop of the padded batch [0, 1,
    2, 2].  The results come back on the lead device."""
    frames = _fleet_windows(scene)
    meshed = _fleet({"data": 2}, chain=chain, max_iter=3)
    assert meshed.n_data_shards == 2 and meshed.n_event_shards == 1 and meshed.mesh.shape == {"data": 2, "event": 1}
    with caplog.at_level(logging.INFO):
        got = meshed.optimize_batch(frames)
    assert len(got) == 3 and meshed.last_batch_stats["syncs"] > 0
    if not chain:
        ref = _fleet(chain=False, max_iter=3)
        want = ref.optimize_batch(frames + frames[2:])
        assert "is not sharded" in caplog.text
        assert meshed.last_batch_stats["loss"] == {s: v[:3] for s, v in ref.last_batch_stats["loss"].items()}
        for g, w in zip(got, want):
            assert all(torch.equal(g[s], w[s]) for s in w)
        return
    refs, wants = [], []
    for d, half in enumerate(([0, 1], [2, 2])):
        ref = _fleet(chain=True, max_iter=3)
        ref.overload_patch_configuration(ref.coarsest_scale)
        for _ in range(2 * d):
            ref.initialize_random()
        want = ref.optimize_batch([frames[i] for i in half])
        assert meshed.last_batch_stats["shards"][d]["loss"] == ref.last_batch_stats["loss"]
        for b, i in enumerate(half[:2 - d]):
            assert sorted(got[i]) == sorted(want[b])
            for s in want[b]:
                assert torch.equal(got[i][s], want[b][s]) and got[i][s].device == CPU
        refs.append(ref)
        wants.append(want)
    meshed.set_previous_frame_best_estimation(got)
    again = meshed.optimize_batch(frames)
    assert len(again) == 3 and meshed.last_batch_stats["shards"][0]["chain"]
    for d, (ref, want) in enumerate(zip(refs, wants)):
        ref.set_previous_frame_best_estimation(want)
        for b, w in enumerate(ref.optimize_batch([frames[i] for i in ([0, 1], [2, 2])[d]])[:2 - d]):
            assert all(torch.equal(again[2 * d + b][s], w[s]) for s in w)


def test_multistream_data_mesh_as_jax():
    """``parallel_config={"data": 2}``: the JAX package's batching rule
    (``auto`` takes the fleet, time-aware too; ``sequential`` raises its
    ``ValueError``), and two pushes of 3 streams (cold, then per-stream
    warm) equal the JAX package's meshed server's to 1e-6, JAX's chain
    draws injected."""
    from test_torch_streaming import SOLVER as S_SOLVER, OPTIMIZER as S_OPT, _window

    ta = dict(S_SOLVER, time_aware=True, time_bin=2, flow_interpolation="burgers", t0_flow_location="middle")
    for mod, kw in ((JSTREAM, {}), (TSTREAM, {"device": "cpu"})):
        assert mod.MultiStreamFlowEstimator((32, 48), 2, solver_config=ta, optimizer_config=S_OPT,
                                            parallel_config={"data": 2}, **kw).batching == "fleet"
        assert mod.MultiStreamFlowEstimator((32, 48), 2, solver_config=ta, optimizer_config=S_OPT,
                                            **kw).batching == "sequential"
        with pytest.raises(ValueError, match="parallel data mesh"):
            mod.MultiStreamFlowEstimator((32, 48), 2, solver_config=S_SOLVER, optimizer_config=S_OPT,
                                         parallel_config={"data": 2}, batching="sequential", **kw)
    opt = dict(S_OPT, chain=True)
    jx, port = (mod.MultiStreamFlowEstimator((32, 48), 3, solver_config=S_SOLVER, optimizer_config=opt,
                                             fixed_event_count=1200, parallel_config={"data": 2}, **kw)
                for mod, kw in ((JSTREAM, {}), (TSTREAM, {"device": "cpu"})))
    port._solver.candidates_fn = ChainDraws(2)
    for step in range(2):
        windows = [_window(0.4 * step, 1600, seed=50 + 10 * k + step) for k in range(3)]
        want, got = jx.push(windows), port.push(windows)
        assert got.shape == (3, 2, 32, 48)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert len(port._solver.previous_frame_best_estimation) == 3 and port.n_batches == jx.n_batches == 2
    assert len(port._solver.candidates_fn.calls) == 2  # one sweep per push
