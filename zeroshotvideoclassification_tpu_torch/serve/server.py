"""HTTP serving front-end: checkpoint -> always-on zero-shot classifier.

Production shape of cli/infer.py: a threading HTTP server (stdlib only — no
extra deps in the image) whose request threads block on the MicroBatcher;
the batcher's stage-1 worker coalesces concurrent requests and decodes them
(GIL-free native decoders) while its stage-2 worker runs the device
dispatch for the PREVIOUS batch (two-stage pipeline, serve/batcher.py).
Copy of zeroshotvideoclassification_tpu/serve/server.py in front of the
port's InferenceEngine.

Endpoints:
  POST /classify   {"videos": ["/path/a.mp4", ...]}           -> results[]
                   (or {"video": "/path/a.mp4"} -> one result)
  POST /reload     {"weights": "/path/checkpoint.npz"}        -> hot-swap the
                   scoring state without restart or recompile (the compiled
                   ladder keys on shapes; in-flight batches finish on the
                   old params). STRICT full framework checkpoints only —
                   anything else (partial match, foreign layout, empty
                   path) is refused so the live model can never silently
                   become (part-)random-init. Subject to the same
                   --data_root admission as /classify.
  GET  /healthz    liveness + model identity
  GET  /stats      request/batch/dispatch counters + latency percentiles

Trust model: /classify takes FILESYSTEM PATHS and decodes them with the
serving process's privileges, so a client can probe file existence and read
any video the process can. The default bind is loopback (127.0.0.1), where
the client already has that access. When exposing beyond loopback
(--host 0.0.0.0), set `data_root`: each request path is realpath-resolved at
admission, rejected with 400 if the resolution falls outside the root, and
the RESOLVED path (not the request string) is what gets decoded — so a
symlink retargeted after the check cannot redirect the open. (Resolution
itself stats the path; existence of out-of-root paths is still probeable,
as it is for any checker short of openat-confinement.)

/reload goes further than read exposure: it MUTATES serving state, with no
auth or rate limit (each call costs a checkpoint load + device_put — cheap,
but not free). The same stance applies: loopback binds trust the local
client; beyond loopback, set `data_root` so a remote client can only swap
between checkpoints you placed under the root (the strict-load contract
above means the worst admissible swap is a different VALID checkpoint of
the same model) — and front anything internet-facing with real auth.

Start:  python -m zeroshotvideoclassification_tpu_torch.cli.serve \
            --weights run/checkpoint.npz --classes "a" "b" --port 8000
"""

from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from zeroshotvideoclassification_tpu_torch.serve.batcher import MicroBatcher
from zeroshotvideoclassification_tpu_torch.serve.engine import InferenceEngine


class ZeroShotService:
    """Engine + batcher + counters; the handler delegates here."""

    def __init__(self, engine: InferenceEngine, max_wait_s: float = 0.01,
                 data_root: Optional[str] = None, pipeline_depth: int = 2):
        self.engine = engine
        # two-stage pipeline: host decode+pack (stage 1) overlaps device
        # dispatch+rank (stage 2) across consecutive micro-batches. Each
        # in-flight packed batch holds its host canvases, so peak host
        # memory scales with pipeline_depth + 2; pipeline_depth=0 disables
        # the pipeline (single-stage, lowest memory).
        if pipeline_depth > 0:
            self.batcher = MicroBatcher(
                self.engine.pack_paths, max_batch=engine.max_batch,
                max_wait_s=max_wait_s, stage2=self.engine.classify_packed,
                pipeline_depth=pipeline_depth)
        else:
            self.batcher = MicroBatcher(
                self.engine.classify, max_batch=engine.max_batch,
                max_wait_s=max_wait_s)
        # in-flight HTTP accounting: handler threads are daemons (stdlib
        # ThreadingHTTPServer), so process exit would kill them between a
        # drained future resolving and the response WRITE — the graceful
        # path below must be able to wait for responses to flush
        self._inflight_cv = threading.Condition()
        self._inflight = 0
        self.n_http = 0
        self.data_root = (os.path.realpath(data_root)
                          if data_root is not None else None)

    def _enter_http(self):
        with self._inflight_cv:
            self._inflight += 1
            self.n_http += 1

    def _exit_http(self):
        with self._inflight_cv:
            self._inflight -= 1
            self._inflight_cv.notify_all()

    def wait_inflight(self, timeout: float) -> bool:
        """Block until no HTTP handler is mid-request (response written),
        or `timeout` elapses; True if fully quiesced."""
        import time as _time

        deadline = _time.monotonic() + timeout
        with self._inflight_cv:
            while self._inflight > 0:
                remaining = deadline - _time.monotonic()
                if remaining <= 0:
                    return False
                self._inflight_cv.wait(remaining)
        return True

    def admit(self, path: str) -> Optional[str]:
        """data_root confinement (module docstring trust model): the
        RESOLVED path if allowed, else None; the caller must decode the
        resolved path, not the request string, so the checked path and the
        opened path are the same (a symlink swapped after this check cannot
        redirect the open). No root configured -> admit verbatim."""
        if self.data_root is None:
            return path
        real = os.path.realpath(path)
        root = self.data_root
        prefix = root if root.endswith(os.sep) else root + os.sep
        return real if (real == root or real.startswith(prefix)) else None

    def classify(self, paths):
        futs = [self.batcher.submit(p) for p in paths]
        return [f.result(timeout=600) for f in futs]

    def stats(self) -> dict:
        return {"http_requests": self.n_http,
                "batcher": self.batcher.stats(),
                "engine": self.engine.stats()}

    def close(self, drain: bool = False, drain_timeout: float = 30.0):
        """drain=True: stop accepting, let accepted requests finish first,
        bounded by `drain_timeout` seconds (the graceful-restart path; see
        MicroBatcher.shutdown). The engine is NOT closed here — it may be
        shared across services (tests, notebooks); its owner calls
        engine.close()."""
        self.batcher.shutdown(drain=drain, drain_timeout=drain_timeout)


def make_handler(service: ZeroShotService):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _read_json(self) -> dict:
            n = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(max(0, n)) or b"{}")

        def do_GET(self):
            service._enter_http()
            try:
                self._do_GET()
            finally:
                service._exit_http()

        def do_POST(self):
            service._enter_http()
            try:
                self._do_POST()
            finally:
                service._exit_http()

        def _do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"status": "ok",
                                 "network": service.engine.config.network,
                                 "classes": len(service.engine.class_names)})
            elif self.path == "/stats":
                self._send(200, service.stats())
            else:
                self._send(404, {"error": f"unknown path {self.path}"})

        def _do_POST(self):
            if self.path == "/reload":
                try:
                    req = self._read_json()
                    weights = req.get("weights")
                    if (not isinstance(weights, str) or not weights
                            or weights == "none"):
                        self._send(400, {"error": "need 'weights': "
                                                  "checkpoint path"})
                        return
                    admitted = service.admit(weights)
                    if admitted is None:
                        self._send(400, {"error": "path outside "
                                                  "--data_root",
                                         "paths": [weights]})
                        return
                    self._send(200, service.engine.reload(admitted))
                except Exception as e:  # noqa: BLE001 — serving must not die
                    self._send(500, {"error": f"{type(e).__name__}: {e}"})
                return
            if self.path != "/classify":
                self._send(404, {"error": f"unknown path {self.path}"})
                return
            try:
                req = self._read_json()
                paths = req.get("videos")
                if paths is None and "video" in req:
                    paths = [req["video"]]
                if not isinstance(paths, list) or not paths:
                    self._send(400, {"error": "need 'videos': [paths] or "
                                              "'video': path"})
                    return
                paths = [str(p) for p in paths]
                admitted = [service.admit(p) for p in paths]
                denied = [p for p, a in zip(paths, admitted) if a is None]
                if denied:
                    self._send(400, {"error": "path outside --data_root",
                                     "paths": denied})
                    return
                # decode the RESOLVED paths (check-and-use on one string);
                # echo the request's own strings back in the results
                results = service.classify(admitted)
                for r, p in zip(results, paths):
                    if isinstance(r, dict) and "video" in r:
                        r["video"] = p
                self._send(200, {"results": results} if "videos" in req
                           else results[0])
            except Exception as e:  # noqa: BLE001 — serving must not die
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def serve_forever(engine: InferenceEngine, host: str = "127.0.0.1",
                  port: int = 8000, max_wait_s: float = 0.01,
                  ready_event: Optional[threading.Event] = None,
                  data_root: Optional[str] = None,
                  pipeline_depth: int = 2,
                  drain_timeout: float = 30.0):
    """Blocking server loop (the cli.serve path); returns None when the
    accept loop stops. For an embeddable non-blocking (server, service)
    pair use start_server.

    SIGTERM (and Ctrl+C) shut down gracefully: the accept loop stops, the
    batcher drains (requests already accepted resolve normally, bounded by
    `drain_timeout` — size it to the slowest legitimate batch, e.g. a
    saturated max_batch of real decodes), and the in-flight handler threads
    get a bounded window to WRITE the drained responses before the process
    exits (rolling-restart semantics; handler threads are daemons, so
    without that wait a response could be cut between its future resolving
    and the socket write)."""
    import signal

    # construct directly (NOT via start_server, which spawns its own
    # accept-loop thread — two serve_forever loops on one socket race
    # each other and the shutdown event)
    service = ZeroShotService(engine, max_wait_s=max_wait_s,
                              data_root=data_root,
                              pipeline_depth=pipeline_depth)
    server = ThreadingHTTPServer((host, port), make_handler(service))
    # server.shutdown() blocks until the accept loop exits, so the handler
    # must not call it inline on the main thread that runs serve_forever
    # below — hand it to a one-shot thread instead. Signals can only be
    # installed from the main thread (tests embed serve_forever elsewhere).
    main_thread = threading.current_thread() is threading.main_thread()
    prev = None
    if main_thread:
        prev = signal.getsignal(signal.SIGTERM)
        signal.signal(signal.SIGTERM, lambda *_: threading.Thread(
            target=server.shutdown, daemon=True).start())
    if ready_event is not None:
        ready_event.set()
    # printed AFTER the signal handler is installed, with the RESOLVED
    # address (with port 0 the configured port says nothing): operational
    # readiness marker — a supervisor that SIGTERMs before this line could
    # otherwise hit the default disposition, and scripts need the real port
    import sys

    print(f"listening on http://{host}:{server.server_address[1]}",
          file=sys.stderr, flush=True)
    try:
        server.serve_forever()
    finally:
        if main_thread:
            signal.signal(signal.SIGTERM, prev)
        try:
            service.close(drain=True, drain_timeout=drain_timeout)
            # the drain resolved every accepted future; give the handler
            # threads a bounded window to serialize + write those responses
            service.wait_inflight(timeout=10.0)
        finally:
            server.server_close()  # release the listening socket


def start_server(engine: InferenceEngine, host: str = "127.0.0.1",
                 port: int = 0, max_wait_s: float = 0.01,
                 data_root: Optional[str] = None,
                 pipeline_depth: int = 2):
    """Non-blocking: bind (port 0 = ephemeral), run the accept loop on a
    daemon thread, return (server, service). Tests and notebooks use this."""
    service = ZeroShotService(engine, max_wait_s=max_wait_s,
                              data_root=data_root,
                              pipeline_depth=pipeline_depth)
    server = ThreadingHTTPServer((host, port), make_handler(service))
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    return server, service
