"""Fleet router — health-gated multi-replica front-end with failover,
hedged retries, and zero-downtime rolling reload: the JAX package's
``serving/router.py``, with its KV keys and record bytes.

The paper's robustness idea is backup workers: the PS averages the first
``num_aggregate`` gradient arrivals so one slow or dead worker never
stalls a step. Serving inverts the direction but keeps the shape — here
the tail-tolerance move is a hedged backup REQUEST: when a routed request
sits past the tail-latency threshold, a second copy goes to a different
replica and the first response wins (requests are idempotent — seeded
sampling makes both copies produce the same tokens, so the race is safe
by construction, exactly like re-averaging the same gradient).

Three pieces, composable and individually testable:

- :class:`FleetRegistrar` (replica side): publishes this replica's record
  — id, URL, readiness state, incarnation, pid, model_step — at
  ``serve/<fleet>/replica/<id>`` in the coordination KV and beats a
  :class:`~ps_pytorch_tpu_torch.resilience.heartbeat.Heartbeat` lease from
  the serve loop. SIGKILL leaves the record behind but the lease goes stale,
  which is exactly the signal the router keys on; a restarted replica
  overwrites its record with ``incarnation + 1`` (the elastic-training
  incarnation idea at the serving plane).

- :class:`FleetView` (router side): folds the KV records, lease
  staleness, and active ``/readyz`` probes into the set of backends that
  may receive traffic. Readiness is the AND of all three — a record that
  says ``ready`` but whose lease is stale is dead; a fresh lease whose
  ``/readyz`` says 503 is draining.

- :class:`Router`: stdlib ThreadingHTTPServer front-end. Per request:
  pick the ready backend with the fewest outstanding requests (ties
  round-robin), forward, and on a RETRYABLE failure (connection error,
  5xx, 503-draining) retry on a DIFFERENT replica with jittered backoff.
  Past ``hedge_s`` without a response, dispatch one hedged backup to
  another replica; first response wins, the loser's socket is closed
  (the replica's ``_send`` treats that as a non-event) and counted.
  ``roll_reload`` composes the replica admin plane (drain → reload →
  resume, watching ``/readyz``) into a rolling checkpoint upgrade across
  the fleet with zero failed requests — at every instant the other
  replicas are ready, so the drain never reduces availability.

Client-visible availability is measured HERE (router_requests vs
router_failed) and fed to the same SLO burn-rate engine the single-replica
plane uses — the router's ``/slo`` is the fleet's page/ticket signal.
"""

import http.client
import json
import random
import socket
import threading
import time
import urllib.parse
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional, Tuple

from ps_pytorch_tpu_torch.resilience.heartbeat import Heartbeat
from ps_pytorch_tpu_torch.telemetry.prometheus import CONTENT_TYPE, render


def fleet_prefix(fleet: str) -> str:
    return f"serve/{fleet}"


class FleetRegistrar:
    """Replica-side fleet membership: one KV record + one heartbeat lease.

    The record at ``serve/<fleet>/replica/<id>`` carries identity and
    readiness state; the lease at ``serve/<fleet>/hb/<id>`` carries
    liveness. They are separate on purpose: a drain flips the record's
    state (planned, router stops sending), a SIGKILL freezes the lease
    (unplanned, router notices within ``lease_timeout_s``)."""

    def __init__(self, kv, fleet: str, replica_id: int, *,
                 lease_interval_s: float = 0.5,
                 clock: Optional[Callable[[], float]] = None):
        self.kv = kv
        self.fleet = fleet
        self.replica_id = int(replica_id)
        self.prefix = fleet_prefix(fleet)
        self.key = f"{self.prefix}/replica/{self.replica_id}"
        self.clock = clock or time.time
        self.heartbeat = Heartbeat(kv, self.prefix, [self.replica_id],
                                   interval_s=lease_interval_s,
                                   clock=self.clock)
        self.record: dict = {}

    def register(self, url: str, model_step: Optional[int] = None,
                 state: str = "ready") -> dict:
        """Publish this replica's record; a restart of the same id bumps
        ``incarnation`` so the router can tell a rejoin from a stale
        record."""
        import os
        incarnation = 0
        prior = self.kv.get(self.key)
        if prior is not None:
            try:
                incarnation = int(json.loads(prior).get("incarnation", -1)) + 1
            except (ValueError, TypeError):
                incarnation = 1
        self.record = {"id": self.replica_id, "url": url, "state": state,
                       "incarnation": incarnation, "pid": os.getpid(),
                       "model_step": model_step, "t": self.clock()}
        self.kv.set(self.key, json.dumps(self.record))
        self.heartbeat.beat(model_step or 0, force=True)
        return self.record

    def set_state(self, state: str,
                  model_step: Optional[int] = None) -> None:
        self.record["state"] = state
        if model_step is not None:
            self.record["model_step"] = model_step
        self.record["t"] = self.clock()
        self.kv.set(self.key, json.dumps(self.record))
        self.heartbeat.beat(self.record.get("model_step") or 0, force=True)

    def beat(self, model_step: int = 0) -> bool:
        """Throttled lease refresh — sits in the serve loop."""
        return self.heartbeat.beat(model_step)

    def deregister(self) -> None:
        self.kv.delete(self.key)
        self.kv.delete(f"{self.prefix}/hb/{self.replica_id}")


@dataclass
class Backend:
    """Router-side view of one replica."""
    id: int
    url: str
    state: str = "starting"
    incarnation: int = 0
    pid: int = 0
    model_step: Optional[int] = None
    # runtime (router-owned)
    healthy: bool = True          # last probe / forward verdict
    lease_fresh: bool = True
    outstanding: int = 0          # in-flight requests via this router
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False)

    @property
    def ready(self) -> bool:
        return self.state == "ready" and self.healthy and self.lease_fresh

    @property
    def host_port(self) -> Tuple[str, int]:
        u = urllib.parse.urlparse(self.url)
        return u.hostname or "127.0.0.1", u.port or 80


class FleetView:
    """The router's health gate: KV records ∧ lease freshness ∧ /readyz.

    ``poll`` re-reads the KV and (optionally) probes each candidate's
    ``/readyz``; ``backends`` returns the stable Backend objects (the
    router mutates ``outstanding``/``healthy`` on them between polls, so
    identity is preserved across refreshes — keyed by replica id, and a
    bumped incarnation resets the runtime fields)."""

    def __init__(self, kv, fleet: str, *, lease_timeout_s: float = 3.0,
                 probe_timeout_s: float = 0.5, probe: bool = True,
                 clock: Optional[Callable[[], float]] = None):
        self.kv = kv
        self.prefix = fleet_prefix(fleet)
        self.lease_timeout_s = float(lease_timeout_s)
        self.probe_timeout_s = float(probe_timeout_s)
        self.probe = probe
        self.clock = clock or time.time
        self._backends: Dict[int, Backend] = {}
        self._lock = threading.Lock()
        self.ejections = 0

    def _lease_age(self, rid: int, now: float) -> Optional[float]:
        v = self.kv.get(f"{self.prefix}/hb/{rid}")
        if v is None:
            return None
        try:
            _, ts = json.loads(v)
            return now - float(ts)
        except (ValueError, TypeError):
            return None

    def _probe_ready(self, b: Backend) -> bool:
        host, port = b.host_port
        try:
            conn = http.client.HTTPConnection(host, port,
                                              timeout=self.probe_timeout_s)
            try:
                conn.request("GET", "/readyz")
                return conn.getresponse().status == 200
            finally:
                conn.close()
        except OSError:
            return False

    def poll(self) -> List[Backend]:
        """Refresh the backend set from the KV (+ probes); returns READY
        backends."""
        now = self.clock()
        records = {}
        for key in self.kv.keys(f"{self.prefix}/replica/"):
            v = self.kv.get(key)
            if v is None:
                continue
            try:
                rec = json.loads(v)
                records[int(rec["id"])] = rec
            except (ValueError, TypeError, KeyError):
                continue    # a torn record is an absent record
        with self._lock:
            for rid in list(self._backends):
                if rid not in records:
                    del self._backends[rid]    # deregistered
            for rid, rec in records.items():
                b = self._backends.get(rid)
                inc = int(rec.get("incarnation", 0))
                if b is None or b.incarnation != inc \
                        or b.url != rec["url"]:
                    b = Backend(id=rid, url=rec["url"], incarnation=inc)
                    self._backends[rid] = b
                b.state = rec.get("state", "starting")
                b.pid = int(rec.get("pid", 0) or 0)
                b.model_step = rec.get("model_step")
                age = self._lease_age(rid, now)
                b.lease_fresh = age is not None \
                    and age <= self.lease_timeout_s
            candidates = [b for b in self._backends.values()
                          if b.state == "ready" and b.lease_fresh]
        for b in candidates:
            was = b.healthy
            if self.probe:
                b.healthy = self._probe_ready(b)
            else:
                b.healthy = True
            if was and not b.healthy:
                self.ejections += 1
        with self._lock:
            return [b for b in self._backends.values() if b.ready]

    def backends(self) -> List[Backend]:
        with self._lock:
            return list(self._backends.values())

    def eject(self, b: Backend) -> None:
        """Forward-path failure: mark unhealthy NOW (the next poll may
        readmit it if /readyz recovers)."""
        if b.healthy:
            b.healthy = False
            self.ejections += 1


class _Attempt:
    """One forwarded request on its own thread, cancellable by closing the
    socket (the loser of a hedge race)."""

    def __init__(self, backend: Backend, payload: bytes, timeout_s: float):
        self.backend = backend
        self.payload = payload
        self.timeout_s = timeout_s
        self.status: Optional[int] = None
        self.body: Optional[dict] = None
        self.error: Optional[BaseException] = None
        self.cancelled = False
        self.done = threading.Event()
        self._conn: Optional[http.client.HTTPConnection] = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"route-{backend.id}")

    def start(self) -> "_Attempt":
        with self.backend._lock:
            self.backend.outstanding += 1
        self._thread.start()
        return self

    def _run(self) -> None:
        host, port = self.backend.host_port
        try:
            conn = http.client.HTTPConnection(host, port,
                                              timeout=self.timeout_s)
            self._conn = conn
            conn.request("POST", "/v1/generate", body=self.payload,
                         headers={"Content-Type": "application/json",
                                  "Content-Length": str(len(self.payload))})
            resp = conn.getresponse()
            data = resp.read()
            self.status = resp.status
            try:
                self.body = json.loads(data or b"{}")
            except ValueError:
                self.body = {"error": "non-JSON backend response"}
        except BaseException as e:     # noqa: BLE001 — surfaced to caller
            self.error = e
        finally:
            with self.backend._lock:
                self.backend.outstanding -= 1
            conn, self._conn = self._conn, None
            if conn is not None:
                try:
                    conn.close()
                except OSError:
                    pass
            self.done.set()

    def cancel(self) -> None:
        """Close the socket under the worker thread — its blocked read
        errors out and the thread exits; the backend's write side treats
        the broken pipe as a non-event."""
        self.cancelled = True
        conn = self._conn
        if conn is not None:
            try:
                # shutdown() actually wakes a recv() blocked in another
                # thread; close() alone may leave it parked until timeout.
                sock = getattr(conn, "sock", None)
                if sock is not None:
                    sock.shutdown(socket.SHUT_RDWR)
                conn.close()
            except OSError:
                pass

    @property
    def retryable(self) -> bool:
        """A failure worth trying on a DIFFERENT replica: the replica is
        unreachable/dying (connection error), erroring (5xx), or refusing
        admission (503 draining / queue full). 4xx is the client's fault
        and 504 means the deadline already passed — neither improves on
        another replica."""
        if self.error is not None:
            return True
        return self.status in (500, 502, 503)


class Router:
    """Health-gated fleet front-end (see module docstring).

    Programmatic use: ``route(body)`` returns ``(status, response_dict)``.
    Server use: ``start()`` binds a ThreadingHTTPServer exposing
    ``POST /v1/generate`` (forwarded), ``GET /healthz`` (router liveness +
    per-backend view), ``GET /metrics`` (Prometheus, when built with a
    registry), ``GET /slo`` (routed-availability burn rates, when built
    with an SLO tracker)."""

    def __init__(self, view: FleetView, *, registry=None, slo=None,
                 retries: int = 2, backoff_s: float = 0.05,
                 hedge_s: float = 0.0, request_timeout_s: float = 60.0,
                 refresh_s: float = 0.5, host: str = "127.0.0.1",
                 port: int = 0, seed: int = 0,
                 clock: Callable[[], float] = time.monotonic):
        self.view = view
        self.registry = registry
        self.slo = slo
        self.retries = int(retries)
        self.backoff_s = float(backoff_s)
        self.hedge_s = float(hedge_s)
        self.request_timeout_s = float(request_timeout_s)
        self.refresh_s = float(refresh_s)
        self.clock = clock
        self._rng = random.Random(seed)
        self._rr = 0
        self._lock = threading.Lock()
        self.counters: Dict[str, int] = {
            "requests": 0, "failed": 0, "retries": 0, "hedges": 0,
            "hedge_wins": 0, "hedge_cancelled": 0}
        self._host, self._port = host, port
        self.port: Optional[int] = None
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._http_thread: Optional[threading.Thread] = None
        self._refresh_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ---- backend selection ----
    def _pick(self, exclude: frozenset) -> Optional[Backend]:
        """Least-outstanding among ready backends not in ``exclude``;
        ties break round-robin so idle fleets still spread load."""
        ready = [b for b in self.view.backends()
                 if b.ready and b.id not in exclude]
        if not ready:
            # One forced refresh before giving up — the KV may know about
            # a replica the cached view predates.
            ready = [b for b in self.view.poll() if b.id not in exclude]
            if not ready:
                return None
        lo = min(b.outstanding for b in ready)
        tied = [b for b in ready if b.outstanding == lo]
        with self._lock:
            self._rr += 1
            return tied[self._rr % len(tied)]

    def _inc(self, name: str, n: int = 1) -> None:
        if self.registry is not None:
            try:
                self.registry.inc(name, n)
            except KeyError:
                pass   # registry without the router contract declared

    # ---- the routed request ----
    def route(self, body: dict,
              deadline_s: Optional[float] = None) -> Tuple[int, dict]:
        """Forward ``body`` to the fleet: least-outstanding pick, hedged
        past ``hedge_s``, failover to a different replica on retryable
        failures. Returns (status, response)."""
        t0 = self.clock()
        payload = json.dumps(body).encode("utf-8")
        timeout_s = min(self.request_timeout_s,
                        (deadline_s or self.request_timeout_s) + 10.0)
        tried: set = set()
        code, obj = 503, {"error": "no ready backends"}
        for round_no in range(self.retries + 1):
            got = self._race(payload, frozenset(tried), timeout_s)
            if got is None:           # nothing left to try
                break
            code, obj, attempted = got
            tried.update(attempted)
            if 200 <= code < 500 and code != 503:
                break
            if round_no < self.retries:
                self.counters["retries"] += 1
                self._inc("router_retries")
                # jittered backoff before the next replica
                time.sleep(self.backoff_s * (1 + self._rng.random()))
        latency = self.clock() - t0
        self.counters["requests"] += 1
        self._inc("router_requests")
        failed = code >= 500
        if failed:
            self.counters["failed"] += 1
            self._inc("router_failed")
        if self.registry is not None:
            try:
                self.registry.observe("router_request_latency_s", latency)
                self.registry.set(
                    "router_outstanding",
                    sum(b.outstanding for b in self.view.backends()))
            except KeyError:
                pass
        if self.slo is not None:
            # Routed availability: the client-visible verdict. 503 with no
            # ready backend is an availability miss, not a rejection — the
            # fleet, not the client, is at fault.
            self.slo.observe_request(
                outcome="done" if code == 200 else
                        ("rejected" if code in (400, 404, 413) else "failed"),
                latency_s=latency if code == 200 else None)
        return code, obj

    def _race(self, payload: bytes, exclude: frozenset, timeout_s: float):
        """One primary attempt (+ optional hedge). Returns
        (status, body, {backend ids attempted}) or None when no backend
        was available at all."""
        primary_b = self._pick(exclude)
        if primary_b is None:
            return None
        attempts = [_Attempt(primary_b, payload, timeout_s).start()]
        hedged = False
        deadline = self.clock() + timeout_s
        while True:
            if not hedged and self.hedge_s > 0:
                fired = attempts[0].done.wait(self.hedge_s)
                hedged = True
                if not fired:
                    hb = self._pick(exclude | {primary_b.id})
                    if hb is not None:
                        self.counters["hedges"] += 1
                        self._inc("router_hedges")
                        attempts.append(
                            _Attempt(hb, payload, timeout_s).start())
                continue
            winner = next((a for a in attempts
                           if a.done.is_set() and not a.retryable), None)
            if winner is not None:
                break
            if all(a.done.is_set() for a in attempts):
                winner = None   # every attempt failed retryably
                break
            if self.clock() > deadline:
                winner = None
                break
            # short joint wait; first completion re-evaluates
            for a in attempts:
                if a.done.wait(0.005):
                    break
        attempted = {a.backend.id for a in attempts}
        # cancel + count losers; eject backends that errored at the socket
        for a in attempts:
            if a is winner:
                continue
            if not a.done.is_set():
                a.cancel()
                self.counters["hedge_cancelled"] += 1
                self._inc("router_hedge_cancelled")
            elif a.error is not None:
                self.view.eject(a.backend)
                self._inc("router_backend_ejections")
        if winner is None:
            # propagate the most informative failure we saw
            for a in attempts:
                if a.status is not None:
                    return a.status, a.body or {}, attempted
            err = next((a.error for a in attempts if a.error is not None),
                       None)
            return 502, {"error": f"backend unreachable: {err}"}, attempted
        if len(attempts) > 1 and winner is attempts[-1]:
            self.counters["hedge_wins"] += 1
            self._inc("router_hedge_wins")
        return winner.status, winner.body or {}, attempted

    # ---- rolling reload ----
    def roll_reload(self, *, settle_timeout_s: float = 30.0,
                    poll_s: float = 0.05) -> List[dict]:
        """Zero-downtime checkpoint upgrade: per ready replica — drain,
        wait for in-flight slots to hit zero, force a reload, resume, and
        wait for ``/readyz`` to go 200 again before touching the next
        replica. Returns one result dict per replica."""
        results = []
        for b in sorted(self.view.poll(), key=lambda x: x.id):
            res = {"id": b.id, "url": b.url, "reloaded": False,
                   "model_step": None, "ok": False}
            try:
                self._admin(b, "/admin/drain")
                t_end = time.monotonic() + settle_timeout_s
                while time.monotonic() < t_end:
                    st = self._get_json(b, "/readyz")[1]
                    if int(st.get("active_slots", 0)) == 0:
                        break
                    time.sleep(poll_s)
                code, got = self._admin(b, "/admin/reload")
                res["reloaded"] = bool(got.get("reloaded"))
                res["model_step"] = got.get("model_step")
                self._admin(b, "/admin/resume")
                t_end = time.monotonic() + settle_timeout_s
                while time.monotonic() < t_end:
                    if self._get_json(b, "/readyz")[0] == 200:
                        res["ok"] = True
                        break
                    time.sleep(poll_s)
            except OSError as e:
                res["error"] = str(e)
            results.append(res)
        self.view.poll()
        return results

    def _admin(self, b: Backend, path: str) -> Tuple[int, dict]:
        host, port = b.host_port
        conn = http.client.HTTPConnection(host, port, timeout=10.0)
        try:
            conn.request("POST", path, body=b"",
                         headers={"Content-Length": "0"})
            resp = conn.getresponse()
            return resp.status, json.loads(resp.read() or b"{}")
        finally:
            conn.close()

    def _get_json(self, b: Backend, path: str) -> Tuple[int, dict]:
        host, port = b.host_port
        conn = http.client.HTTPConnection(host, port, timeout=10.0)
        try:
            conn.request("GET", path)
            resp = conn.getresponse()
            return resp.status, json.loads(resp.read() or b"{}")
        finally:
            conn.close()

    # ---- server lifecycle ----
    def start(self) -> None:
        router = self

        class Handler(_RouterHandler):
            rt = router

        self.view.poll()
        self._httpd = ThreadingHTTPServer((self._host, self._port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever,
            kwargs=dict(poll_interval=0.05), daemon=True, name="router-http")
        self._http_thread.start()
        if self.refresh_s > 0:
            self._refresh_thread = threading.Thread(
                target=self._refresh_loop, daemon=True,
                name="router-refresh")
            self._refresh_thread.start()

    def _refresh_loop(self) -> None:
        while not self._stop.wait(self.refresh_s):
            ready = self.view.poll()
            if self.registry is not None:
                try:
                    self.registry.set("router_backends_ready", len(ready))
                except KeyError:
                    pass

    def stop(self) -> None:
        self._stop.set()
        if self._refresh_thread is not None:
            self._refresh_thread.join(timeout=5.0)
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

    def status(self) -> dict:
        return {
            "ok": True,
            "counters": dict(self.counters),
            "ejections": self.view.ejections,
            "backends": [{
                "id": b.id, "url": b.url, "state": b.state,
                "ready": b.ready, "healthy": b.healthy,
                "lease_fresh": b.lease_fresh, "outstanding": b.outstanding,
                "incarnation": b.incarnation, "model_step": b.model_step,
            } for b in sorted(self.view.backends(), key=lambda x: x.id)],
        }


class _RouterHandler(BaseHTTPRequestHandler):
    rt: Router = None          # bound per-router in start()
    protocol_version = "HTTP/1.1"

    def log_message(self, *args):
        pass

    def _send(self, code: int, obj: dict) -> None:
        payload = json.dumps(obj).encode("utf-8")
        try:
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)
        except (BrokenPipeError, ConnectionError, OSError):
            self.close_connection = True

    def do_GET(self):
        if self.path == "/healthz":
            self._send(200, self.rt.status())
        elif self.path == "/metrics":
            if self.rt.registry is None:
                self._send(404, {"error": "router has no metric registry"})
            else:
                payload = render(self.rt.registry).encode("utf-8")
                try:
                    self.send_response(200)
                    self.send_header("Content-Type", CONTENT_TYPE)
                    self.send_header("Content-Length", str(len(payload)))
                    self.end_headers()
                    self.wfile.write(payload)
                except (BrokenPipeError, ConnectionError, OSError):
                    self.close_connection = True
        elif self.path == "/slo":
            if self.rt.slo is None:
                self._send(404, {"error": "router has no SLO tracker"})
            else:
                self._send(200, self.rt.slo.evaluate())
        else:
            self._send(404, {"error": f"no route {self.path}"})

    def do_POST(self):
        if self.path == "/admin/roll_reload":
            self._send(200, {"results": self.rt.roll_reload()})
            return
        if self.path != "/v1/generate":
            self._send(404, {"error": f"no route {self.path}"})
            return
        try:
            n = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(n) or b"{}")
            if not isinstance(body, dict):
                raise ValueError("body must be a JSON object")
        except (ValueError, json.JSONDecodeError) as e:
            self._send(400, {"error": f"bad JSON body: {e}"})
            return
        deadline = body.get("deadline_s")
        code, obj = self.rt.route(
            body, deadline_s=float(deadline) if deadline else None)
        self._send(code, obj)
