"""Stdlib JSON HTTP front-end for the serving engine — no new dependencies:
the JAX package's ``serving/server.py``, with the same routes, status codes
and JSON bodies.

One ``ThreadingHTTPServer`` thread per connection parks on its request's
event while ONE ``serve_loop`` thread drives the engine (admission, batched
decode, hot reload) — HTTP threads touch host state only; the drive thread
owns every tensor and every call on the card.

API (JSON in, JSON out):

- ``POST /v1/generate``   body: ``{"prompt": "<utf-8 text>"}`` OR
  ``{"tokens": [int, ...]}`` plus optional ``n_new`` / ``temperature`` /
  ``top_k`` / ``seed`` / ``deadline_s``. 200 → ``{"tokens", "text",
  "ttft_ms", "latency_ms", "model_step", "rid"}``; 400 invalid request;
  503 queue full / draining (retryable on another replica); 504 deadline
  shed or timeout.
- ``GET /healthz``        liveness + slot/queue occupancy (+ watchdog state
  when the frontend was built with a ``HealthMonitor``; + leader identity
  fields — ``leader``/``leader_epoch``/``leader_pid`` — when the served
  checkpoints come from an elastic training run). Always HTTP 200 —
  orchestration liveness probes key on the ``ok`` field, not the status.
- ``GET /readyz``         READINESS, distinct from liveness: HTTP 200 only
  while the replica is in state ``ready``; 503 while ``starting`` or
  ``draining`` (the process is alive but must not receive traffic — the
  router's health gate and any LB keys on the status code). The body
  carries ``state``/``active_slots``/``queue_depth``/``model_step`` so a
  drain orchestrator can watch in-flight work hit zero.
- ``POST /admin/drain``   enter ``draining``: stop admitting (new submits
  are rejected, queued requests are shed and their callers unblocked),
  keep finishing in-flight slots. ``POST /admin/resume`` re-enters
  ``ready``. ``POST /admin/reload`` force-polls the checkpoint watcher and
  swaps params if a newer valid checkpoint landed (the rolling-reload
  orchestrator calls drain → reload → resume per replica).
- ``GET /stats``          engine/queue counters (+ registry snapshot).
- ``GET /metrics``        Prometheus text exposition of the engine registry
  (404 when the engine was built without one).
- ``GET /slo``            the SLO tracker's multi-window evaluation
  (state, compliance, per-objective burn rates; 404 without ``--slo-spec``).
- ``GET /debug/requests`` the request-trace ring — sampling stats + every
  kept lifecycle record; ``?text=1`` renders an aligned table instead of
  JSON (404 when request tracing is off).
"""

import json
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from ps_pytorch_tpu_torch.serving.engine import (Request, ServingEngine,
                                                 serve_loop)
from ps_pytorch_tpu_torch.serving.queue import AdmissionQueue
from ps_pytorch_tpu_torch.serving.reqtrace import (format_requests_table,
                                                   record_terminal)
from ps_pytorch_tpu_torch.telemetry.prometheus import CONTENT_TYPE, render


class ServingFrontend:
    """Engine + queue + watcher + HTTP server, one ``start()`` away.

    ``port=0`` binds an ephemeral port (tests); read ``self.port`` after
    ``start``. ``default_deadline_s`` bounds how long a request may wait
    end-to-end when the caller doesn't send ``deadline_s``."""

    def __init__(self, engine: ServingEngine, *, watcher=None,
                 host: str = "127.0.0.1", port: int = 0,
                 max_queue: int = 64, reload_s: float = 10.0,
                 default_deadline_s: float = 30.0,
                 default_n_new: int = 128, health=None, identity=None,
                 max_body_bytes: int = 1 << 20, registrar=None,
                 injector=None, advertise: str = ""):
        self.engine = engine
        self.health = health
        self.max_body_bytes = int(max_body_bytes)
        # Fleet plane (optional): registrar publishes this replica's
        # readiness record in the coordination KV; injector arms the
        # replica_kill drill fault. Both ride the serve loop.
        self.registrar = registrar
        self.injector = injector
        self.advertise = advertise
        # Readiness state machine: starting -> ready <-> draining -> dead.
        # /readyz keys on this; /healthz (liveness) never does.
        self.state = "starting"
        # Static identity fields merged into /healthz (leader/role/epoch of
        # the training run that produced the served weights); checkpoint
        # reloads refresh the epoch from the new checkpoint's meta.
        self.identity = dict(identity or {})
        # The queue resolves shed/rejected requests itself, so it needs the
        # same trace/SLO sinks the engine feeds for completions.
        self.queue = AdmissionQueue(max_queue, clock=engine.clock,
                                    registry=engine.registry,
                                    reqtrace=engine.reqtrace,
                                    slo=engine.slo)
        self.watcher = watcher
        self.reload_s = reload_s
        self.default_deadline_s = float(default_deadline_s)
        self.default_n_new = int(default_n_new)
        self._stop = threading.Event()
        self._loop: Optional[threading.Thread] = None
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._http_thread: Optional[threading.Thread] = None
        self._host, self._port = host, port
        self.port: Optional[int] = None
        self._reload_lock = threading.Lock()

    # ---- lifecycle ----
    def start(self) -> None:
        self._loop = threading.Thread(
            target=serve_loop, args=(self.engine, self.queue),
            kwargs=dict(watcher=self.watcher, reload_s=self.reload_s,
                        stop=self._stop, clock=self.engine.clock,
                        health=self.health, injector=self.injector,
                        registrar=self.registrar),
            daemon=True, name="serve-loop")
        self._loop.start()
        frontend = self

        class Handler(_Handler):
            fe = frontend

        self._httpd = ThreadingHTTPServer((self._host, self._port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs=dict(poll_interval=0.05),
            daemon=True, name="serve-http")
        self._http_thread.start()
        self.state = "ready"
        if self.registrar is not None:
            self.registrar.register(
                url=f"http://{self.advertise or self._host}:{self.port}",
                model_step=self.engine.model_step)

    @property
    def url(self) -> str:
        return f"http://{self._host}:{self.port}"

    def drain(self) -> int:
        """Enter ``draining``: readiness goes 503, new submits are
        rejected, everything queued is shed (callers unblock NOW), and
        in-flight slots keep decoding to completion. Returns the number
        of queued requests shed. Idempotent."""
        self.state = "draining"
        if self.registrar is not None:
            self.registrar.set_state("draining")
        return self.queue.close("draining")

    def resume(self) -> None:
        """Leave ``draining`` and admit traffic again."""
        self.queue.reopen()
        self.state = "ready"
        if self.registrar is not None:
            self.registrar.set_state("ready")

    def reload_now(self) -> tuple:
        """Force one watcher poll (the /admin/reload path — works with the
        periodic poll disabled). Returns (reloaded, model_step)."""
        if self.watcher is None:
            return False, self.engine.model_step
        with self._reload_lock:
            got = self.watcher.poll()
        if got is None:
            return False, self.engine.model_step
        self.engine.set_params(got.params, step=got.step)
        return True, got.step

    def stop(self, drain_timeout_s: float = 10.0) -> None:
        """Graceful shutdown: drain (queued requests resolve immediately),
        give in-flight slots up to ``drain_timeout_s`` to finish under the
        still-running loop, then stop the loop, fail any leftovers so no
        HTTP thread stays parked until its wait-timeout, deregister, and
        close the listener."""
        self.drain()
        deadline = time.monotonic() + max(0.0, drain_timeout_s)
        while self.engine.active_count and time.monotonic() < deadline:
            time.sleep(0.01)
        self._stop.set()
        if self._loop is not None:
            self._loop.join(timeout=10.0)
        # Anything still active lost the drain race (loop stopped first):
        # resolve it as failed so its caller unblocks now.
        for req in self.engine.active_requests():
            self.engine._fail(req, "server stopped")
        # And anything that slipped into the queue between close() and the
        # loop stopping (close is idempotent; re-close sheds them).
        self.queue.close("server stopping")
        if self.registrar is not None:
            self.registrar.deregister()
        self.state = "dead"
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self._http_thread is not None:
            self._http_thread.join(timeout=10.0)

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()

    # ---- request handling (called from HTTP threads) ----
    def handle_generate(self, body: dict) -> tuple:
        """(status_code, response_dict) for one POST /v1/generate body."""
        if "tokens" in body:
            toks = body["tokens"]
            if (not isinstance(toks, list)
                    or not all(isinstance(t, int) for t in toks)):
                return 400, {"error": "tokens must be a list of ints"}
            prompt = np.asarray(toks, np.int32)
        elif "prompt" in body:
            if not isinstance(body["prompt"], str):
                return 400, {"error": "prompt must be a string"}
            prompt = np.frombuffer(
                body["prompt"].encode("utf-8"), np.uint8).astype(np.int32)
        else:
            return 400, {"error": "need 'prompt' (text) or 'tokens' (ints)"}
        try:
            n_new = int(body.get("n_new", self.default_n_new))
            temperature = float(body.get("temperature", 0.8))
            top_k = int(body.get("top_k", 40))
            seed = int(body.get("seed", 0))
            deadline_s = float(body.get("deadline_s",
                                        self.default_deadline_s))
        except (TypeError, ValueError) as e:
            return 400, {"error": f"bad field: {e}"}
        if self.state != "ready":
            # Drain/startup gate: 503 is the router's signal to try a
            # different replica (retryable, unlike a 4xx).
            return 503, {"error": self.state}
        now = self.engine.clock()
        req = Request(prompt=prompt, n_new=n_new, temperature=temperature,
                      top_k=top_k, seed=seed, rid=uuid.uuid4().hex[:12],
                      deadline_t=now + deadline_s)
        req.t_submit = now
        try:
            self.engine.validate(req)
        except ValueError as e:
            return 400, {"error": str(e), "rid": req.rid}
        if not self.queue.submit(req):
            return 503, {"error": req.error or "queue full", "rid": req.rid}
        # Park this HTTP thread until the serve loop resolves the request
        # (grace past the deadline so shedding reports as 504, not timeout).
        if not req.wait(deadline_s + 5.0):
            # First-wins: the serve loop may resolve concurrently with this
            # timeout — only the CAS winner records the terminal sample.
            if req._resolve("failed", "server wait timeout"):
                record_terminal(req, reqtrace=self.engine.reqtrace,
                                slo=self.engine.slo, now=self.engine.clock())
                return 504, {"error": "timed out", "rid": req.rid}
            self.engine._lost_race()
        if req.state == "shed":
            # Drain sheds are the REPLICA's doing, not the deadline's: 503
            # so a fleet router retries them on another replica (504 would
            # surface a rolling reload as a client-visible failure).
            code = 503 if req.error in ("draining", "server stopping") \
                else 504
            return code, {"error": req.error, "rid": req.rid}
        if req.state != "done":
            return 500, {"error": req.error or req.state, "rid": req.rid}
        resp = {
            "rid": req.rid,
            "tokens": [int(t) for t in req.tokens],
            "model_step": req.model_step,
            "ttft_ms": (req.t_first - req.t_submit) * 1e3,
            "latency_ms": (req.t_done - req.t_submit) * 1e3,
        }
        if all(0 <= t < 256 for t in req.tokens):
            resp["text"] = bytes(req.tokens).decode("utf-8", "replace")
        return 200, resp

    def readiness(self) -> tuple:
        """(status_code, body) for GET /readyz."""
        e = self.engine
        body = {"ready": self.state == "ready", "state": self.state,
                "active_slots": e.active_count,
                "queue_depth": self.queue.depth(),
                "model_step": e.model_step}
        return (200 if self.state == "ready" else 503), body

    def stats(self) -> dict:
        e, q = self.engine, self.queue
        out = {
            "state": self.state,
            "slots": e.slots, "active_slots": e.active_count,
            "model_step": e.model_step, "ticks": e.ticks,
            "served": e.served, "tokens_out": e.tokens_out,
            "queue_depth": q.depth(), "submitted": q.submitted,
            "rejected_full": q.rejected_full,
            "rejected_closed": q.rejected_closed,
            "shed_deadline": q.shed_deadline,
        }
        if self.watcher is not None:
            out["reloads"] = self.watcher.reloads
            out["skipped_corrupt"] = self.watcher.skipped_corrupt
        if e.registry is not None:
            out["metrics"] = e.registry.snapshot()
        return out


class _Handler(BaseHTTPRequestHandler):
    fe: ServingFrontend = None      # bound per-frontend in start()
    protocol_version = "HTTP/1.1"

    def log_message(self, *args):    # quiet: telemetry covers observability
        pass

    def _send(self, code: int, obj: dict) -> None:
        self._send_bytes(code, json.dumps(obj).encode("utf-8"),
                         "application/json")

    def _send_text(self, code: int, text: str, content_type: str) -> None:
        self._send_bytes(code, text.encode("utf-8"), content_type)

    def _send_bytes(self, code: int, payload: bytes,
                    content_type: str) -> None:
        # A cancelled hedge loser (router closed the socket mid-wait) makes
        # the write fail — that's a non-event, not a handler crash.
        try:
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)
        except (BrokenPipeError, ConnectionError, OSError):
            self.close_connection = True

    def do_GET(self):
        if self.path == "/readyz":
            code, body = self.fe.readiness()
            self._send(code, body)
        elif self.path == "/healthz":
            e = self.fe.engine
            out = {"ok": True, "slots_free": e.free_slots,
                   "queue_depth": self.fe.queue.depth(),
                   "model_step": e.model_step}
            out.update(self.fe.identity)
            w = self.fe.watcher
            if w is not None and getattr(w, "last_meta", None):
                for k in ("leader_epoch", "leader_pid"):
                    if k in w.last_meta:
                        out[k] = w.last_meta[k]
            if self.fe.health is not None:
                out["health"] = self.fe.health.status()
                out["ok"] = bool(out["health"]["ok"])
            self._send(200, out)
        elif self.path == "/metrics":
            reg = self.fe.engine.registry
            if reg is None:
                self._send(404, {"error": "engine has no metric registry"})
            else:
                self._send_text(200, render(reg), CONTENT_TYPE)
        elif self.path == "/stats":
            self._send(200, self.fe.stats())
        elif self.path == "/slo":
            slo = self.fe.engine.slo
            if slo is None:
                self._send(404, {"error": "no SLO tracker (serve with "
                                          "--slo-spec)"})
            else:
                self._send(200, slo.evaluate())
        elif self.path.split("?")[0] == "/debug/requests":
            log = self.fe.engine.reqtrace
            if log is None:
                self._send(404, {"error": "request tracing off (serve "
                                          "with --reqtrace-keep > 0)"})
            elif "text=1" in (self.path.split("?") + [""])[1]:
                rows = log.snapshot()
                self._send_text(200, format_requests_table(rows),
                                "text/plain; charset=utf-8")
            else:
                self._send(200, {"stats": log.stats(),
                                 "requests": log.snapshot()})
        else:
            self._send(404, {"error": f"no route {self.path}"})

    def do_POST(self):
        if self.path == "/admin/drain":
            shed = self.fe.drain()
            self._send(200, {"state": self.fe.state, "shed": shed,
                             "active_slots": self.fe.engine.active_count})
            return
        if self.path == "/admin/resume":
            self.fe.resume()
            self._send(200, {"state": self.fe.state})
            return
        if self.path == "/admin/reload":
            if self.fe.watcher is None:
                self._send(404, {"error": "no checkpoint watcher"})
                return
            reloaded, step = self.fe.reload_now()
            self._send(200, {"reloaded": reloaded, "model_step": step})
            return
        if self.path != "/v1/generate":
            self._send(404, {"error": f"no route {self.path}"})
            return
        # Bound the body BEFORE reading a byte: a misbehaving client must
        # not make this connection thread buffer arbitrary bytes.
        cl = self.headers.get("Content-Length")
        if cl is None:
            self._send(400, {"error": "Content-Length required"})
            return
        try:
            n = int(cl)
            if n < 0:
                raise ValueError(cl)
        except (TypeError, ValueError):
            self._send(400, {"error": f"bad Content-Length {cl!r}"})
            return
        if n > self.fe.max_body_bytes:
            reg = self.fe.engine.registry
            if reg is not None:
                try:
                    reg.inc("serve_rejected_oversize")
                except KeyError:
                    pass   # registry predates the oversize counter
            self._send(413, {"error": f"body {n} bytes > limit "
                                      f"{self.fe.max_body_bytes}"})
            self.close_connection = True
            return
        try:
            body = json.loads(self.rfile.read(n) or b"{}")
            if not isinstance(body, dict):
                raise ValueError("body must be a JSON object")
        except (ValueError, json.JSONDecodeError) as e:
            self._send(400, {"error": f"bad JSON body: {e}"})
            return
        code, obj = self.fe.handle_generate(body)
        self._send(code, obj)
