"""HTTP serving front-end for the streaming flow estimator (port of
``event_based_optical_flow_tpu/serve.py``).

A minimal, dependency-free (stdlib ``http.server``) network surface so a
deployment can push event windows from another process or host and get
dense flow back, on top of ``streaming.StreamingFlowEstimator``:

    python -m event_based_optical_flow_tpu_torch.serve --height 260 --width 346 [--device cuda|cpu]

Protocol (npz over HTTP, no pickling):
    POST /flow    body: npz with ``events`` [n, 4] float (x=height, y=width,
                  t seconds, p) -> 200, npz with ``flow`` [2, H, W]
                  float32 (px displacement over the window; [T, 2, H, W]
                  — per-bin fields — for time-aware solver configs) and
                  ``span``
    POST /reset   drop the warm-start chain (scene cut)
    GET  /healthz 200 JSON {"status": "ok", "n_windows": N}

Pushes are serialized with a lock (the solver owns device state); use one
server per card and batch streams with ``MultiStreamFlowEstimator`` when
many clients share one.  The state file (``--state-path``) has the JAX
package's layout, so either package's server resumes the other's.
"""

import argparse
import io
import json
import logging
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

logger = logging.getLogger(__name__)


class FlowServer:
    """Wraps a StreamingFlowEstimator behind an HTTP server.  Construct,
    then ``serve_forever()`` (or ``start()`` for a background thread —
    the pattern the tests use)."""

    def __init__(self, image_shape, host="127.0.0.1", port=8080,
                 solver_config=None, optimizer_config=None,
                 fixed_event_count=None, state_path=None, warmup=False, device="cuda"):
        from .streaming import StreamingFlowEstimator

        self.estimator = StreamingFlowEstimator(
            image_shape,
            solver_config=solver_config,
            optimizer_config=optimizer_config,
            fixed_event_count=fixed_event_count,
            device=device,
        )
        if state_path and not str(state_path).endswith(".npz"):
            # np.savez appends .npz when missing — normalize so the
            # resume check looks for the file that is actually written
            state_path = str(state_path) + ".npz"
        self.state_path = state_path
        if state_path and os.path.exists(state_path):
            self.estimator.load_state(state_path)
            logger.info(f"resumed serving state from {state_path}")
        if warmup:
            # pay the kernels' build, the first solves and the chain's
            # captures at server start, not on the first client push; a
            # resumed warm chain survives (warmup restores the pre-warmup
            # state)
            logger.info("warming up the solve ...")
            dt = self.estimator.warmup()
            logger.info(f"warmup done in {dt:.1f}s (cold + warm windows)")
        # one solve at a time: the chain's CUDA graph captures and replays
        # share the solver's static buffers
        self._lock = threading.Lock()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # route through logging
                logger.info("%s - %s", self.address_string(), fmt % args)

            def _send(self, code, body, ctype):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    body = json.dumps(
                        {"status": "ok", "n_windows": outer.estimator.n_windows}
                    ).encode()
                    self._send(200, body, "application/json")
                else:
                    self._send(404, b"not found", "text/plain")

            def do_POST(self):
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    payload = self.rfile.read(n)
                    if self.path == "/reset":
                        with outer._lock:
                            outer.estimator.reset()
                            if outer.state_path:
                                # persist the cleared state: a restart
                                # must not resurrect the pre-reset chain
                                outer.estimator.save_state(outer.state_path)
                        self._send(200, b"{}", "application/json")
                        return
                    if self.path != "/flow":
                        self._send(404, b"not found", "text/plain")
                        return
                    data = np.load(io.BytesIO(payload), allow_pickle=False)
                    events = np.asarray(data["events"], np.float64)
                    with outer._lock:
                        flow = outer.estimator.push(events)
                        # span of the SOLVED window (may include borrowed
                        # tail events under fixed_event_count) — the
                        # correct px/s scale for the returned displacement
                        span = outer.estimator.last_span
                        if outer.state_path:
                            outer.estimator.save_state(outer.state_path)
                    buf = io.BytesIO()
                    np.savez_compressed(
                        buf,
                        flow=np.asarray(flow, np.float32),
                        span=np.float64(span),
                    )
                    self._send(200, buf.getvalue(), "application/octet-stream")
                except Exception as e:  # report, keep serving
                    logger.exception("flow request failed")
                    body = json.dumps({"error": str(e)}).encode()
                    self._send(400, body, "application/json")

        self.httpd = ThreadingHTTPServer((host, int(port)), Handler)
        self._thread = None

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def start(self):
        """Serve on a daemon thread (tests / embedding)."""
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True
        )
        self._thread.start()
        return self

    def serve_forever(self):
        logger.info(f"serving dense flow on port {self.port}")
        self.httpd.serve_forever()

    def shutdown(self):
        self.httpd.shutdown()
        self.httpd.server_close()  # release the listening socket fd
        if self._thread is not None:
            self._thread.join(timeout=10)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--height", type=int, required=True)
    ap.add_argument("--width", type=int, required=True)
    ap.add_argument("--fixed-event-count", type=int, default=None)
    ap.add_argument("--state-path", default=None,
                    help="persist/resume warm-start state across restarts")
    ap.add_argument("--warmup", action="store_true",
                    help="solve a cold and a warm synthetic window before accepting traffic")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the solve runs (cuda: the CUDA kernels; cpu: their plain versions)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    FlowServer(
        (args.height, args.width), args.host, args.port,
        fixed_event_count=args.fixed_event_count, state_path=args.state_path,
        warmup=args.warmup, device=args.device,
    ).serve_forever()


if __name__ == "__main__":
    main()
