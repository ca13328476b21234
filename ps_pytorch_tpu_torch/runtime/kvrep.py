"""Quorum-replicated coordination plane, the JAX package's
``runtime/kvrep.py``: the control plane survives the loss of the KV
itself.

Elections, membership, masks, leases and the wire all ride one KV. The
process group's TCPStore is served by process 0, and a directory is one
disk: either is a single point of failure. :class:`ReplicatedKV` presents
the same ``set/get/delete/keys`` interface over N independent backends
with quorum semantics, so no single backend process or disk can kill a
run.

* **Tagged envelopes.** Every replicated value is framed as
  ``"@kvr1 <version> <writer>\\n<payload>"``, byte for byte the JAX
  package's, so a process of either package reads the other's backends.
  ``version`` is per-key monotonic (each client bumps past the newest tag
  it has *observed*, so read-modify-write contenders such as lease
  claimants order correctly); ``writer`` breaks version ties the same way
  for every reader. Unframed values parse as tag ``(0, "")``, the oldest.
* **Majority writes.** ``set`` fans out to every non-ejected backend in
  parallel and needs ``quorum`` acks; fewer raises
  :class:`TransientKVError` (UNAVAILABLE), so the RetryingKV layer above
  retries the LOGICAL op and charges its budget once an op.
* **Newest-of-quorum reads with read repair.** ``get`` gathers a quorum
  of replies, returns the newest tag's payload, and writes that envelope
  back to every responder that was stale or missing the key.
* **Health scoring.** Consecutive failures eject a backend; an ejected
  backend sits out a jittered, growing probation, then a probe and an
  anti-entropy resync readmit it.
* **Anti-entropy resync.** A rejoining backend (possibly wiped) gets a
  full scan diff against the healthy majority: newest tag wins per key,
  and keys the majority does not hold are deleted from the rejoiner.

Deletes are quorum best-effort and carry no tombstones: every consumer
keys its data monotonically or judges staleness from lease timestamps.
A backend must answer ``keys()``: ``FileKV`` (``dir:``), ``HttpKV``
(``http://``) or the in-process ``KVStore`` (``mem:``), never the
TCPStore, which has no scan.

The module also ships a stdlib HTTP backend (:func:`serve_kv`, ``python
-m ps_pytorch_tpu_torch.runtime.kvrep``, and the client :class:`HttpKV`),
so a drill can SIGKILL a real backend process; the fault kinds
``kv_backend_kill`` / ``kv_backend_wipe`` (``resilience/faults.py``) cover
the deterministic half.
"""

import argparse
import json
import socket
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ps_pytorch_tpu_torch.resilience.faults import TransientKVError
from ps_pytorch_tpu_torch.runtime.coordinator import FileKV, KVStore

_MAGIC = "@kvr1 "
Tag = Tuple[int, str]


def wrap_value(version: int, writer: str, value: str) -> str:
    """Frame ``value`` with its ``(version, writer)`` tag. ``writer`` must
    not contain spaces/newlines (enforced at ReplicatedKV construction)."""
    return f"{_MAGIC}{int(version)} {writer}\n{value}"


def unwrap_value(raw: Optional[str]) -> Tuple[Optional[Tag], Optional[str]]:
    """``raw`` -> ``(tag, payload)``. None -> ``(None, None)`` (absent).
    Unframed text -> tag ``(0, "")``: pre-replication data is valid but
    loses to any tagged write."""
    if raw is None:
        return None, None
    if raw.startswith(_MAGIC):
        head, nl, body = raw.partition("\n")
        parts = head[len(_MAGIC):].split(" ")
        if nl and len(parts) == 2:
            try:
                return (int(parts[0]), parts[1]), body
            except ValueError:
                pass
    return (0, ""), raw


def peek_tag(raw: Optional[str]) -> Optional[Tag]:
    """Tag of ``raw`` WITHOUT slicing the payload off — the read path
    compares every replica's tag but only needs one payload copy, and the
    wire transport ships multi-MB values where n extra copies per get
    would eat the replication budget."""
    if raw is None:
        return None
    if raw.startswith(_MAGIC):
        nl = raw.find("\n")
        if nl >= 0:
            parts = raw[len(_MAGIC):nl].split(" ")
            if len(parts) == 2:
                try:
                    return (int(parts[0]), parts[1])
                except ValueError:
                    pass
    return (0, "")


class _Backend:
    """Per-backend health record. ``spec`` is the human-readable address
    the logs/drills report; mutation happens under ReplicatedKV._hlock."""

    def __init__(self, kv, index: int, spec: str = ""):
        self.kv = kv
        self.index = index
        self.spec = spec or f"backend{index}"
        self.failures = 0        # consecutive — reset on any success
        self.ejected = False
        self.ejections = 0       # lifetime — drives probation backoff
        self.probe_at = 0.0      # clock deadline for the next rejoin probe


class ReplicatedKV:
    """KVStore-shaped quorum replication over N independent backends.

    Drop-in under every existing consumer: elections, membership, the
    hierarchy transport, the integrity ledger, FleetRegistrar/FleetView
    all see one ordinary KV. Compose with the resilience shims in the
    usual order — ReplicatedKV INSIDE RetryingKV — so a sub-quorum
    outage surfaces as one retryable logical failure.
    """

    def __init__(self, backends: List, quorum: int = 0, writer: str = "w0",
                 clock: Optional[Callable[[], float]] = None,
                 resync_s: float = 1.0, eject_after: int = 2,
                 specs: Optional[List[str]] = None, seed: int = 0):
        if not backends:
            raise ValueError("ReplicatedKV needs at least one backend")
        if any(c in writer for c in (" ", "\n")):
            raise ValueError(f"writer id {writer!r} must not contain "
                             f"spaces or newlines (it rides the envelope)")
        n = len(backends)
        majority = n // 2 + 1
        quorum = int(quorum) or majority
        if not majority <= quorum <= n:
            raise ValueError(
                f"kv_quorum={quorum} is unsafe for {n} backends: quorum "
                f"must be in [{majority}, {n}] so any two quorums overlap")
        specs = specs or [""] * n
        self._backends = [_Backend(kv, i, specs[i])
                          for i, kv in enumerate(backends)]
        self.n = n
        self.quorum = quorum
        self.writer = writer
        self._clock = clock or time.monotonic
        self.resync_s = max(float(resync_s), 1e-3)
        self.eject_after = max(int(eject_after), 1)
        self._rng = np.random.default_rng(seed)
        # Observed-newest tag per key: sets bump PAST this, so a client
        # that read version v writes v+1 even though its own counter
        # never issued v — the read-modify-write ordering lease claims
        # depend on.
        self._versions: Dict[str, Tag] = {}
        self._vlock = threading.Lock()
        self._hlock = threading.RLock()   # backend health + probation
        # Healthy-path fast lane: the active list is rebuilt under _hlock
        # whenever an ejected flag flips and read lock-free everywhere
        # else (list swap is atomic), and _n_ejected == 0 short-circuits
        # _tick. Every op pays these lookups, so they must not cost a
        # lock acquisition each in the no-fault steady state.
        self._active_list: List[_Backend] = list(self._backends)
        self._n_ejected = 0
        # Sized for CONCURRENT callers: the overlapped wire transport
        # issues KV ops from several worker threads at once, each needing
        # n-1 pool slots for its fan-out; an n-sized pool would serialize
        # them and erase the transport's overlap win.
        self._pool = ThreadPoolExecutor(
            max_workers=max(4, 4 * n), thread_name_prefix="kvrep")
        self.counters: Dict[str, int] = {
            "kvrep_quorum_failures": 0, "kvrep_backend_errors": 0,
            "kvrep_ejections": 0, "kvrep_rejoins": 0,
            "kvrep_read_repairs": 0, "kvrep_resyncs": 0,
            "kvrep_resync_keys": 0, "kvrep_probes": 0}

    # ---- health plane ----
    def _active(self) -> List[_Backend]:
        return self._active_list

    def _rebuild_active(self) -> None:
        # Caller holds _hlock.
        self._active_list = [b for b in self._backends if not b.ejected]
        self._n_ejected = self.n - len(self._active_list)

    def healthy_count(self) -> int:
        return len(self._active())

    def _backoff_s(self, ejections: int) -> float:
        """Jittered growing probation: base * 2^(ejections-1), capped at
        64x, shrunk up to 25% by the seeded stream so a fleet of clients
        does not probe a struggling backend in lockstep."""
        grow = 2.0 ** min(max(ejections - 1, 0), 6)
        return self.resync_s * grow * (1.0 - 0.25 * float(self._rng.random()))

    def _record(self, b: _Backend, ok: bool) -> None:
        if ok and not b.failures:
            return          # steady state: no lock on the healthy path
        with self._hlock:
            if ok:
                b.failures = 0
                return
            b.failures += 1
            self.counters["kvrep_backend_errors"] += 1
            if not b.ejected and b.failures >= self.eject_after:
                b.ejected = True
                b.ejections += 1
                b.probe_at = self._clock() + self._backoff_s(b.ejections)
                self.counters["kvrep_ejections"] += 1
                self._rebuild_active()

    def _tick(self) -> None:
        """Probation clock: any ejected backend past its probe deadline
        gets one rejoin attempt (probe + anti-entropy resync). Runs at
        the top of every op — rejoin cost lands on one unlucky op, which
        is fine for a control plane and keeps the class thread-only."""
        if not self._n_ejected:
            return
        with self._hlock:
            due = [b for b in self._backends
                   if b.ejected and self._clock() >= b.probe_at]
        for b in due:
            self.counters["kvrep_probes"] += 1
            try:
                b.kv.get("kvrep/__probe__", None)
                self._resync(b)
            except Exception:
                with self._hlock:
                    b.ejections += 1
                    b.probe_at = self._clock() + self._backoff_s(b.ejections)
                continue
            with self._hlock:
                b.ejected = False
                b.failures = 0
                self.counters["kvrep_rejoins"] += 1
                self._rebuild_active()

    # ---- fan-out plumbing ----
    def _map(self, fn: Callable, backends: List[_Backend]):
        """Run ``fn(backend)`` on every backend in parallel; returns
        ``[(backend, ok, result_or_exc)]`` and feeds the health score.
        Wait-for-all on purpose: read-repair and resync need the full
        picture, and backends answer in parallel so the wall cost is the
        slowest responder, not the sum. The first backend runs on the
        CALLING thread after the others are submitted (the caller would
        otherwise idle for one RTT anyway), and completion is collected
        via ``Future.exception()`` — which blocks per future — rather
        than an explicit ``wait()``, whose waiter setup costs more than
        the whole fan-out tax budget; together these keep the per-op
        replication cost inside the <5% budget the kvrep bench row
        asserts."""
        if not backends:
            return []
        submit = self._pool.submit
        futs = [(submit(fn, b), b) for b in backends[1:]]
        first = backends[0]
        try:
            first_res = (True, fn(first))
        except Exception as exc:  # recorded, never raised here
            first_res = (False, exc)
        out = []
        self._record(first, first_res[0])
        out.append((first, first_res[0], first_res[1]))
        for fut, b in futs:
            try:
                res = fut.result()
            except Exception as exc:
                self._record(b, False)
                out.append((b, False, exc))
            else:
                self._record(b, True)
                out.append((b, True, res))
        return out

    def _observe(self, key: str, tag: Tag) -> None:
        with self._vlock:
            if tag > self._versions.get(key, (0, "")):
                self._versions[key] = tag

    # ---- KV interface ----
    def set(self, key: str, value: str) -> None:
        self._tick()
        with self._vlock:
            ver = self._versions.get(key, (0, ""))[0] + 1
            self._versions[key] = (ver, self.writer)
        env = wrap_value(ver, self.writer, value)
        results = self._map(lambda b: b.kv.set(key, env), self._active())
        acks = sum(1 for _, ok, _ in results if ok)
        if acks < self.quorum:
            self.counters["kvrep_quorum_failures"] += 1
            raise TransientKVError(
                f"UNAVAILABLE: quorum write got {acks}/{self.quorum} acks "
                f"({self.n} backends, {self.n - len(results)} ejected) "
                f"for key {key!r}")

    def get(self, key: str, default: Optional[str] = None) -> Optional[str]:
        self._tick()
        results = self._map(lambda b: b.kv.get(key, None), self._active())
        replies = [(b, r) for b, ok, r in results if ok]
        if len(replies) < self.quorum:
            self.counters["kvrep_quorum_failures"] += 1
            raise TransientKVError(
                f"UNAVAILABLE: quorum read got {len(replies)}/{self.quorum} "
                f"replies for key {key!r}")
        best_tag, best_raw = None, None
        parsed = []
        for b, raw in replies:
            tag = peek_tag(raw)   # header-only: no payload copy per replica
            parsed.append((b, tag))
            if tag is not None and (best_tag is None or tag > best_tag):
                best_tag, best_raw = tag, raw
        if best_tag is None:
            return default
        self._observe(key, best_tag)
        best_val = unwrap_value(best_raw)[1]   # the ONE payload copy
        if best_tag > (0, ""):
            # Re-frame unframed finds so repair propagates a tagged copy.
            best_env = (best_raw if best_raw.startswith(_MAGIC)
                        else wrap_value(best_tag[0], best_tag[1], best_val))
            stale = [b for b, tag in parsed
                     if tag is None or tag < best_tag]
            if stale:
                env = best_env
                self._map(lambda b: b.kv.set(key, env), stale)
                self.counters["kvrep_read_repairs"] += len(stale)
        return best_val

    def delete(self, key: str) -> None:
        self._tick()
        with self._vlock:
            self._versions.pop(key, None)
        results = self._map(lambda b: b.kv.delete(key), self._active())
        acks = sum(1 for _, ok, _ in results if ok)
        if acks < self.quorum:
            self.counters["kvrep_quorum_failures"] += 1
            raise TransientKVError(
                f"UNAVAILABLE: quorum delete got {acks}/{self.quorum} acks "
                f"for key {key!r}")

    def keys(self, prefix: str = "") -> List[str]:
        self._tick()
        results = self._map(lambda b: b.kv.keys(prefix), self._active())
        oks = [r for _, ok, r in results if ok]
        if len(oks) < self.quorum:
            self.counters["kvrep_quorum_failures"] += 1
            raise TransientKVError(
                f"UNAVAILABLE: quorum scan got {len(oks)}/{self.quorum} "
                f"replies for prefix {prefix!r}")
        # Union: a quorum-committed key is missing from at most
        # n - quorum backends, and quorum responders overlap every write
        # quorum, so the union is complete for committed keys.
        seen = set()
        for ks in oks:
            seen.update(ks)
        return sorted(seen)

    # ---- anti-entropy ----
    def _resync(self, rejoin: _Backend) -> None:
        """Full prefix-scan diff bringing ``rejoin`` (possibly wiped) to
        tag-equality with the healthy majority. Newest tag wins per key;
        keys absent from every healthy backend are deleted from the
        rejoiner — the majority forgot them (GC/delete) or never
        committed them (sub-quorum orphan), and quorum overlap means a
        committed key cannot look majority-absent."""
        healthy = [b for b in self._active() if b is not rejoin]
        if len(healthy) < self.quorum:
            raise TransientKVError(
                f"UNAVAILABLE: resync needs a quorum of healthy peers "
                f"({len(healthy)}/{self.quorum} up)")
        scans = self._map(lambda b: b.kv.keys(""), healthy)
        good = [(b, ks) for b, ok, ks in scans if ok]
        if len(good) < self.quorum:
            raise TransientKVError("UNAVAILABLE: resync scan lost quorum")
        union = set(rejoin.kv.keys(""))
        for _, ks in good:
            union.update(ks)
        repaired = 0
        for key in sorted(union):
            reads = self._map(lambda b: b.kv.get(key, None), healthy)
            copies = [(b, raw) for b, ok, raw in reads if ok]
            tags = {}
            best_tag, best_env = None, None
            for b, raw in copies:
                tag, val = unwrap_value(raw)
                tags[b.index] = tag
                if tag is not None and (best_tag is None or tag > best_tag):
                    best_tag = tag
                    best_env = raw if raw.startswith(_MAGIC) else \
                        wrap_value(tag[0], tag[1], val)
            r_tag, _ = unwrap_value(rejoin.kv.get(key, None))
            if best_tag is None:
                # No healthy copy: a sub-quorum orphan or a GC'd key —
                # the rejoiner must not resurrect it.
                if r_tag is not None:
                    rejoin.kv.delete(key)
                    repaired += 1
                continue
            if r_tag is None or r_tag < best_tag:
                rejoin.kv.set(key, best_env)
                repaired += 1
            # Heal lagging HEALTHY peers met during the scan too — the
            # diff already paid for the reads.
            for b, raw in copies:
                tag = tags[b.index]
                if tag is None or tag < best_tag:
                    try:
                        b.kv.set(key, best_env)
                        repaired += 1
                    except Exception:
                        pass
        self.counters["kvrep_resyncs"] += 1
        self.counters["kvrep_resync_keys"] += repaired

    def resync_backend(self, index: int) -> None:
        """Force one anti-entropy pass for backend ``index`` (drill /
        admin hook; the probation clock does this automatically)."""
        self._resync(self._backends[index])

    # ---- introspection (drills, telemetry, tests) ----
    def backend_tags(self, index: int, prefix: str = "") -> Dict[str, Tag]:
        """Raw per-key tags on one backend — no quorum, no repair. The
        drill's key-by-key tag-equality verification reads these."""
        b = self._backends[index]
        out = {}
        for key in b.kv.keys(prefix):
            tag, _ = unwrap_value(b.kv.get(key, None))
            if tag is not None:
                out[key] = tag
        return out

    def snapshot(self) -> Dict[str, int]:
        return dict(self.counters)

    def gauges(self) -> Dict[str, float]:
        return {"kvrep_backends": float(self.n),
                "kvrep_backends_healthy": float(self.healthy_count())}


# ---------------------------------------------------------------------------
# HTTP backend: a real, separately killable KV process.
# ---------------------------------------------------------------------------

class HttpKV(KVStore):
    """KVStore client over the :func:`serve_kv` wire — one base URL per
    backend process. Connection-level failures raise
    :class:`TransientKVError` (UNAVAILABLE text), so both the replica
    health score and the textual retry classifier treat a SIGKILLed
    backend exactly like a gRPC outage."""

    def __init__(self, base: str, timeout_s: float = 2.0):
        super().__init__()
        self.base = base.rstrip("/")
        self.timeout_s = float(timeout_s)

    def _request(self, method: str, path: str,
                 body: Optional[bytes] = None) -> Tuple[int, bytes]:
        import urllib.error
        import urllib.request
        req = urllib.request.Request(self.base + path, data=body,
                                     method=method)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()
        except (urllib.error.URLError, ConnectionError, socket.timeout,
                OSError) as e:
            raise TransientKVError(
                f"UNAVAILABLE: kv backend {self.base} unreachable ({e})")

    @staticmethod
    def _q(s: str) -> str:
        from urllib.parse import quote
        return quote(s, safe="")

    def set(self, key: str, value: str) -> None:
        status, body = self._request(
            "PUT", f"/kv?key={self._q(key)}", value.encode())
        if status != 204:
            raise RuntimeError(f"kv backend {self.base} set {key!r} -> "
                               f"{status} {body[:128]!r}")

    def get(self, key: str, default: Optional[str] = None) -> Optional[str]:
        status, body = self._request("GET", f"/kv?key={self._q(key)}")
        if status == 200:
            return body.decode()
        if status == 404:
            return default
        raise RuntimeError(f"kv backend {self.base} get {key!r} -> {status}")

    def delete(self, key: str) -> None:
        status, _ = self._request("DELETE", f"/kv?key={self._q(key)}")
        if status not in (204, 404):
            raise RuntimeError(f"kv backend {self.base} delete {key!r} -> "
                               f"{status}")

    def keys(self, prefix: str = "") -> List[str]:
        status, body = self._request("GET", f"/keys?prefix={self._q(prefix)}")
        if status != 200:
            raise RuntimeError(f"kv backend {self.base} keys -> {status}")
        return list(json.loads(body.decode()))


def serve_kv(port: int, root: Optional[str] = None, host: str = "127.0.0.1"):
    """Start one KV backend server (ThreadingHTTPServer, daemon threads)
    over an in-process dict (``root=None`` — state dies with the process,
    which is what the wipe drill wants) or a FileKV directory. Returns
    the live server; callers run ``serve_forever`` themselves."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from urllib.parse import parse_qs, unquote, urlsplit

    store = FileKV(root) if root else KVStore()

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *args):        # chatter stays out of drills
            pass

        def _param(self, name: str) -> str:
            q = parse_qs(urlsplit(self.path).query)
            return unquote(q.get(name, [""])[0])

        def _reply(self, status: int, body: bytes = b"") -> None:
            self.send_response(status)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            if body:
                self.wfile.write(body)

        def do_GET(self):
            path = urlsplit(self.path).path
            if path == "/healthz":
                self._reply(200, b"ok")
            elif path == "/kv":
                val = store.get(self._param("key"), None)
                if val is None:
                    self._reply(404)
                else:
                    self._reply(200, val.encode())
            elif path == "/keys":
                body = json.dumps(store.keys(self._param("prefix")))
                self._reply(200, body.encode())
            else:
                self._reply(404)

        def do_PUT(self):
            length = int(self.headers.get("Content-Length", 0))
            store.set(self._param("key"), self.rfile.read(length).decode())
            self._reply(204)

        def do_DELETE(self):
            store.delete(self._param("key"))
            self._reply(204)

    srv = ThreadingHTTPServer((host, port), Handler)
    srv.daemon_threads = True
    return srv


def main(argv: Optional[List[str]] = None) -> int:
    """``python -m ps_pytorch_tpu_torch.runtime.kvrep --port 7781`` — one
    backend process for the replication drills (SIGKILL it; restarting
    it fresh IS the wipe)."""
    ap = argparse.ArgumentParser(description="replicated-KV backend server")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--root", default="",
                    help="FileKV directory (default: in-process dict, "
                         "state dies with the process)")
    args = ap.parse_args(argv)
    srv = serve_kv(args.port, root=args.root or None, host=args.host)
    print(f"KVSERVER ready host={args.host} port={args.port} "
          f"root={args.root or '<mem>'}", flush=True)
    try:
        srv.serve_forever(poll_interval=0.2)
    except KeyboardInterrupt:
        pass
    return 0


# ---------------------------------------------------------------------------
# Config plumbing: spec strings -> backends -> one wired ReplicatedKV.
# ---------------------------------------------------------------------------

def parse_backend_specs(spec: str) -> List[str]:
    """``--kv-replicas`` grammar: comma-separated backend addresses —
    ``dir:<path>`` (FileKV), ``http://host:port`` (HttpKV), ``mem:``
    (in-process dict; tests/drills). Empty string = replication off."""
    out = [s.strip() for s in (spec or "").split(",") if s.strip()]
    for s in out:
        if not (s.startswith("dir:") or s.startswith("http://")
                or s.startswith("https://") or s in ("mem", "mem:")):
            raise ValueError(
                f"bad kv replica spec {s!r}: expected dir:<path>, "
                f"http(s)://host:port, or mem:")
    return out


def build_backend(spec: str):
    if spec.startswith("dir:"):
        return FileKV(spec[len("dir:"):])
    if spec.startswith(("http://", "https://")):
        return HttpKV(spec)
    return KVStore()


def build_replicated_kv(cfg, process_index: int = 0, injector=None,
                        clock=None):
    """One ReplicatedKV from ``cfg.kv_replicas``/``kv_quorum``/
    ``kv_resync_s``. When the fault plane is armed with per-backend
    kinds (``kv_backend_kill``/``kv_backend_wipe``) each backend gets
    its index-scoped shim INSIDE the replication layer — the quorum
    math, not the retry budget, is what must absorb a dead backend."""
    specs = parse_backend_specs(getattr(cfg, "kv_replicas", ""))
    if not specs:
        raise ValueError("build_replicated_kv called with empty kv_replicas")
    backends = [build_backend(s) for s in specs]
    if injector is not None and getattr(injector, "has_backend_faults",
                                        False):
        backends = [injector.wrap_backend(kv, i)
                    for i, kv in enumerate(backends)]
    return ReplicatedKV(
        backends, quorum=int(getattr(cfg, "kv_quorum", 0) or 0),
        writer=f"p{int(process_index)}",
        resync_s=float(getattr(cfg, "kv_resync_s", 1.0) or 1.0),
        clock=clock, specs=specs,
        seed=int(getattr(cfg, "seed", 0)) + 131 * int(process_index))


if __name__ == "__main__":
    sys.exit(main())
