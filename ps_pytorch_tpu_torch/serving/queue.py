"""Bounded admission queue with backpressure and deadline shedding: the
JAX package's ``serving/queue.py``.

The queue is the pressure valve between an unbounded outside world and
``slots`` of fixed decode capacity: ``submit`` rejects immediately when the
queue is full (HTTP 503 territory — the caller learns NOW, not after a
deadline's worth of waiting), and requests whose absolute deadline passed
while they waited are shed (they would miss it anyway; decoding them would
only push the next request over too). Shedding runs at three points so an
expired request's caller is unblocked as soon as possible, not only when
the engine happens to drain the queue:

- ``take``: on the way out (the original path);
- ``submit``: arrival of a NEWER request evicts every already-expired one
  first — which also frees depth, so a queue full of corpses still admits
  live traffic instead of bouncing it with 503s;
- ``reap``: called by the serve loop's idle tick, so expired requests
  resolve within one ``idle_wait_s`` even when nothing else arrives.

All three resolve the request object so a waiting server thread unblocks
immediately instead of burning the full grace timeout.
"""

import threading
import time
from collections import deque
from typing import Callable, Optional

from ps_pytorch_tpu_torch.serving.engine import Request
from ps_pytorch_tpu_torch.serving.reqtrace import record_terminal


class AdmissionQueue:
    """FIFO with a hard depth bound and deadline-aware shedding."""

    def __init__(self, max_depth: int, *,
                 clock: Callable[[], float] = time.monotonic, registry=None,
                 reqtrace=None, slo=None):
        if max_depth < 1:
            raise ValueError(f"max_depth={max_depth} (need >= 1)")
        self.max_depth = int(max_depth)
        self.clock = clock
        self.registry = registry
        self.reqtrace = reqtrace
        self.slo = slo
        self._q: deque = deque()
        self._lock = threading.Lock()
        self._nonempty = threading.Condition(self._lock)
        self.submitted = 0
        self.rejected_full = 0
        self.rejected_closed = 0
        self.shed_deadline = 0
        self.taken = 0
        self._closed = False

    def depth(self) -> int:
        with self._lock:
            return len(self._q)

    def _shed_locked(self, req: Request, now: float,
                     reason: str = "deadline passed while queued") -> None:
        if not req._resolve("shed", reason):
            return   # lost the terminal CAS; winner already recorded it
        self.shed_deadline += 1
        if self.registry is not None:
            self.registry.inc("serve_shed")
        record_terminal(req, reqtrace=self.reqtrace, slo=self.slo, now=now)

    def _reap_locked(self, now: float) -> int:
        """Drop every queued request whose deadline already passed (scan is
        bounded by max_depth). Lock held by the caller."""
        if not self._q:
            return 0
        live = deque()
        shed = 0
        for req in self._q:
            if req.deadline_t is not None and now > req.deadline_t:
                self._shed_locked(req, now)
                shed += 1
            else:
                live.append(req)
        if shed:
            self._q = live
        return shed

    def reap(self, now: Optional[float] = None) -> int:
        """Shed expired requests without waiting for a take — the serve
        loop calls this each idle tick. Returns how many were shed."""
        with self._lock:
            return self._reap_locked(self.clock() if now is None else now)

    def submit(self, req: Request) -> bool:
        """Enqueue ``req``; False (and the request resolves ``rejected``)
        when the queue is at max depth — backpressure, not buffering.
        Expired entries are reaped first, so depth pressure is measured
        against requests that can still be served."""
        with self._lock:
            now = self.clock()
            if self._closed:
                self.rejected_closed += 1
                if req._resolve("rejected", "draining"):
                    if self.registry is not None:
                        self.registry.inc("serve_rejected")
                    record_terminal(req, reqtrace=self.reqtrace,
                                    slo=self.slo, now=now)
                return False
            self._reap_locked(now)
            if len(self._q) >= self.max_depth:
                self.rejected_full += 1
                if req._resolve("rejected", "queue full"):
                    if self.registry is not None:
                        self.registry.inc("serve_rejected")
                    record_terminal(req, reqtrace=self.reqtrace,
                                    slo=self.slo, now=now)
                return False
            req.state = "queued"
            if not req.t_submit:
                req.t_submit = now
            req.t_enqueue = now
            self._q.append(req)
            self.submitted += 1
            self._nonempty.notify()
        return True

    def take(self) -> Optional[Request]:
        """Pop the oldest still-viable request (None when empty). Requests
        whose ``deadline_t`` has passed are shed on the way out."""
        with self._lock:
            now = self.clock()
            while self._q:
                req = self._q.popleft()
                if req.deadline_t is not None and now > req.deadline_t:
                    self._shed_locked(req, now)
                    continue
                self.taken += 1
                return req
        return None

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self, reason: str = "server stopping") -> int:
        """Stop admitting (drain mode): subsequent ``submit`` calls resolve
        ``rejected`` immediately, and every request still queued is shed
        NOW with ``reason`` so its waiting server thread unblocks instead
        of parking until its wait-timeout. Returns how many were shed.
        Idempotent."""
        with self._lock:
            self._closed = True
            now = self.clock()
            shed = 0
            while self._q:
                self._shed_locked(self._q.popleft(), now, reason)
                shed += 1
            self._nonempty.notify_all()
            return shed

    def reopen(self) -> None:
        """Leave drain mode (the rolling-reload resume path)."""
        with self._lock:
            self._closed = False

    def wait_nonempty(self, timeout: float) -> bool:
        """Block up to ``timeout`` for the queue to become non-empty (the
        drive loop's idle wait — avoids spinning an empty engine)."""
        with self._lock:
            if self._q:
                return True
            return self._nonempty.wait(timeout)
