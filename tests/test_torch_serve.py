"""The port's HTTP server (``event_based_optical_flow_tpu_torch/serve.py``)
on the CPU, and against the JAX package's server.

* Round trip: ``POST /flow`` (npz in, npz ``flow`` + ``span`` out),
  ``GET /healthz``, a malformed payload (400, the server keeps serving),
  ``POST /reset``, the state file written after every request, and a fresh
  server resuming it.
* The same window pushed to the JAX server (Pallas interpret mode,
  float64) and to the port's (float64 on the CPU, JAX's init-sweep draws
  injected): the same flow, to 1e-6 px plus the float32 rounding of the
  payload; the port's server resumes the JAX server's state file.
"""

import io
import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from event_based_optical_flow_tpu.serve import FlowServer as JaxFlowServer
from event_based_optical_flow_tpu_torch.serve import FlowServer
from test_torch_pyramid import JaxDraws
from test_torch_streaming import OPTIMIZER, SOLVER, H, W, _window

N_FIX = 1500


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _post(base, path, body):
    req = urllib.request.Request(f"{base}{path}", data=body, method="POST")
    with urllib.request.urlopen(req, timeout=300) as resp:
        return resp.status, resp.read()


def _flow(base, events):
    buf = io.BytesIO()
    np.savez(buf, events=events)
    status, body = _post(base, "/flow", buf.getvalue())
    assert status == 200
    out = np.load(io.BytesIO(body))
    return out["flow"], float(out["span"])


def _health(base):
    with urllib.request.urlopen(f"{base}/healthz", timeout=30) as resp:
        return json.loads(resp.read())


def test_flow_server_round_trip(tmp_path):
    state = tmp_path / "serve_state"  # extensionless: np.savez appends .npz
    kw = dict(solver_config=SOLVER, optimizer_config=OPTIMIZER, fixed_event_count=N_FIX,
              state_path=str(state), device="cpu")
    server = FlowServer((H, W), port=0, **kw).start()
    try:
        base = f"http://127.0.0.1:{server.port}"
        flow, span = _flow(base, _window(0.0, 1100, seed=31))
        assert flow.shape == (2, H, W) and flow.dtype == np.float32 and np.isfinite(flow).all()
        assert span > 0 and span == pytest.approx(server.estimator.last_span)
        assert _health(base) == {"status": "ok", "n_windows": 1}
        assert (tmp_path / "serve_state.npz").exists()
        # the second window is topped up from the first's tail: the span is the solved window's
        flow2, span2 = _flow(base, _window(0.4, 1100, seed=32))
        assert np.isfinite(flow2).all() and span2 == pytest.approx(server.estimator.last_span)
        assert _health(base)["n_windows"] == 2
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(base, "/flow", b"junk")
        assert err.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"{base}/nothing", timeout=30)
        assert err.value.code == 404
        assert _health(base)["n_windows"] == 2
        resumed = FlowServer((H, W), port=0, **kw)
        assert resumed.estimator.n_windows == 2
        assert sorted(resumed.estimator._solver.previous_frame_best_estimation) == [1, 2]
        resumed.httpd.server_close()
        assert _post(base, "/reset", b"")[0] == 200
        assert server.estimator._solver.previous_frame_best_estimation is None
    finally:
        server.shutdown()
    # the cleared chain was persisted: a restart does not resurrect it
    after_reset = FlowServer((H, W), port=0, **kw)
    assert after_reset.estimator._solver.previous_frame_best_estimation is None
    assert after_reset.estimator._tail is None
    after_reset.httpd.server_close()


def test_response_matches_the_jax_server(tmp_path):
    """The same two windows to both servers (cold, then warm from the first's
    solution); the port resumes the JAX server's state file."""
    windows = [_window(0.0, 2000, seed=41), _window(0.4, 2000, seed=42)]
    jx = JaxFlowServer((H, W), port=0, solver_config=SOLVER, optimizer_config=OPTIMIZER,
                       fixed_event_count=N_FIX, state_path=str(tmp_path / "jax_state.npz")).start()
    port = FlowServer((H, W), port=0, solver_config=SOLVER, optimizer_config=OPTIMIZER,
                      fixed_event_count=N_FIX, device="cpu").start()
    port.estimator._solver.candidates_fn = JaxDraws()
    try:
        for ev in windows:
            want, want_span = _flow(f"http://127.0.0.1:{jx.port}", ev)
            got, got_span = _flow(f"http://127.0.0.1:{port.port}", ev)
            assert got.shape == want.shape == (2, H, W) and got_span == want_span
            # float32 payloads: the float64 flows' 1e-6, plus one rounding step each
            tol = 1e-6 + 2 * np.spacing(np.float32(np.abs(want).max()))
            np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    finally:
        jx.shutdown()
        port.shutdown()
    resumed = FlowServer((H, W), port=0, solver_config=SOLVER, optimizer_config=OPTIMIZER,
                         fixed_event_count=N_FIX, state_path=str(tmp_path / "jax_state.npz"), device="cpu")
    try:
        assert resumed.estimator.n_windows == 2
        assert sorted(resumed.estimator._solver.previous_frame_best_estimation) == [1, 2]
    finally:
        resumed.httpd.server_close()
