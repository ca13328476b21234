"""Per-process heartbeats + leader-side liveness: the JAX package's
``resilience/heartbeat.py``. Crashed is not slow.

The Coordinator's kofn/deadline policies act on step DURATIONS, which a
dead or preempted host stops reporting entirely: its last duration stays
frozen at a healthy value and the leader keeps waiting for a contribution
that will never come. Heartbeats close that gap. Every process publishes a
``(step, wall_time)`` beat for each replica it owns on the same KV the
control plane rides; the leader's :class:`LivenessMonitor` folds beat
staleness into the participation mask (``Coordinator._decide_mask``), so a
crashed replica is EXCLUDED within a bounded number of steps
(``timeout_s`` of wall time, i.e. ~``timeout_s / step_time + 1`` mask
decisions) and READMITTED on its first fresh beat after recovery.

Bootstrap grace: a replica that has never beaten is treated as alive —
masking the whole world out during startup would wedge step 1. Both ends
must share a clock domain; the default is wall time (``time.time``), and
tests drive both with one ManualClock.
"""

import json
import time
from typing import Callable, Dict, List, Optional

import numpy as np


class Heartbeat:
    """Publisher: one process beating for the replicas it owns.

    ``beat`` is throttled to ``interval_s`` so it can sit unconditionally
    in the step loop; ``force=True`` bypasses the throttle (final beat
    before a planned exit)."""

    def __init__(self, kv, run_id: str, replicas: List[int],
                 interval_s: float = 1.0,
                 clock: Optional[Callable[[], float]] = None):
        self.kv = kv
        self.run_id = run_id
        self.replicas = list(replicas)
        self.interval_s = float(interval_s)
        self.clock = clock or time.time
        self._last = float("-inf")

    def beat(self, step: int, force: bool = False) -> bool:
        now = self.clock()
        if not force and now - self._last < self.interval_s:
            return False
        self._last = now
        for r in self.replicas:
            self.kv.set(f"{self.run_id}/hb/{r}",
                        json.dumps([int(step), now]))
        return True


class LivenessMonitor:
    """Leader-side: per-replica alive/dead from heartbeat staleness.

    A replica is dead when its last beat is older than ``timeout_s``;
    never-seen replicas are alive (bootstrap grace). Transition counters
    (``evictions``/``readmissions``) and a bounded event log feed the
    telemetry plane.
    """

    def __init__(self, kv, run_id: str, n_replicas: int,
                 timeout_s: float = 3.0,
                 clock: Optional[Callable[[], float]] = None,
                 max_events: int = 256):
        self.kv = kv
        self.run_id = run_id
        self.n = int(n_replicas)
        self.timeout_s = float(timeout_s)
        self.clock = clock or time.time
        self._last_ts = np.full(self.n, np.nan)
        self._alive_prev = np.ones(self.n, bool)
        self.counters: Dict[str, int] = {"evictions": 0, "readmissions": 0}
        self.events: List[dict] = []
        self._max_events = max_events

    def _observe(self) -> None:
        for r in range(self.n):
            v = self.kv.get(f"{self.run_id}/hb/{r}")
            if v is None:
                continue
            try:
                _, ts = json.loads(v)
                self._last_ts[r] = float(ts)
            except (ValueError, TypeError):
                continue  # a torn/garbled beat is just a missed beat

    def alive_mask(self) -> np.ndarray:
        """bool[n]; also updates eviction/readmission counters + events."""
        self._observe()
        now = self.clock()
        seen = ~np.isnan(self._last_ts)
        alive = ~seen | (now - np.nan_to_num(self._last_ts) <= self.timeout_s)
        for r in np.nonzero(alive != self._alive_prev)[0]:
            kind = "readmit" if alive[r] else "evict"
            self.counters["evictions" if kind == "evict"
                          else "readmissions"] += 1
            if len(self.events) < self._max_events:
                self.events.append({"event": kind, "replica": int(r),
                                    "t": round(float(now), 3)})
        self._alive_prev = alive
        return alive

    def snapshot(self) -> Dict[str, int]:
        return dict(self.counters)
