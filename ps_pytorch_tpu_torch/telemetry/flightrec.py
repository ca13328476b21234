"""Flight recorder: a copy of the JAX package's ``telemetry/flightrec.py``.

Bounded rings of recent evidence (step records, events, health trips,
periodic registry snapshots), dumped on disaster (a crash, a watchdog
halt) as one atomic JSON artifact (tmp + ``os.replace``) that joins them
with the tracer's span tail and a final registry snapshot. The JAX
package's ``load_flight`` and ``tools/analyze.py flight`` read it.
Recording is O(1) appends on bounded deques, cheap enough for every step.
"""

import json
import os
import time
from collections import deque
from typing import Any, Dict, List, Optional


class FlightRecorder:
    """``record_*`` from the hot loop; ``dump(reason)`` from the cold path.

    ``tracer``/``registry`` are optional joins: when present, dumps carry
    the tracer's most recent ``span_tail`` completed spans and both
    periodic and final registry snapshots.
    """

    def __init__(self, path: str, capacity: int = 256, tracer=None,
                 registry=None, span_tail: int = 512,
                 snapshot_every: int = 32):
        self.path = path
        self.tracer = tracer
        self.registry = registry
        self.span_tail = int(span_tail)
        self.snapshot_every = max(1, int(snapshot_every))
        self.steps: deque = deque(maxlen=int(capacity))
        self.events: deque = deque(maxlen=int(capacity))
        self.health: deque = deque(maxlen=int(capacity))
        self.snapshots: deque = deque(maxlen=16)
        self.dumps = 0
        self._n_steps = 0

    # ---- hot path ----
    def record_step(self, step: int, **fields: Any) -> None:
        rec = {"step": int(step), "t": time.time()}
        rec.update({k: v for k, v in fields.items() if v is not None})
        self.steps.append(rec)
        self._n_steps += 1
        if self.registry is not None \
                and self._n_steps % self.snapshot_every == 0:
            try:
                self.snapshots.append({"step": int(step), "t": time.time(),
                                       "metrics": self.registry.snapshot()})
            except Exception:
                pass    # a snapshot must never break the step loop

    def record_event(self, kind: str, data: Optional[Dict[str, Any]] = None
                     ) -> None:
        rec = {"t": time.time(), **(data or {})}
        rec["kind"] = str(kind)     # the tag wins over any payload key
        self.events.append(rec)

    def record_health(self, ev) -> None:
        """Accepts a HealthEvent or a plain dict."""
        self.health.append(ev.to_dict() if hasattr(ev, "to_dict") else
                           dict(ev))

    # ---- cold path ----
    def _span_tail(self) -> List[dict]:
        if self.tracer is None:
            return []
        try:
            return [dict(e) for e in self.tracer.spans()[-self.span_tail:]]
        except Exception:
            return []

    def dump(self, reason: str, extra: Optional[Dict[str, Any]] = None
             ) -> str:
        """Atomically write the flight artifact; returns the path. Never
        raises (a recorder failure during crash handling would mask the
        real exception) — on error it returns the path unwritten."""
        self.dumps += 1
        doc = {
            "kind": "flight_recorder",
            "reason": str(reason),
            "written_at": time.time(),
            "pid": os.getpid(),
            "dumps": self.dumps,
            "steps": list(self.steps),
            "events": list(self.events),
            "health_events": list(self.health),
            "metric_snapshots": list(self.snapshots),
            "spans": self._span_tail(),
        }
        if self.registry is not None:
            try:
                doc["final_metrics"] = self.registry.snapshot()
            except Exception:
                pass
        if extra:
            doc["extra"] = dict(extra)
        try:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            tmp = f"{self.path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, self.path)
        except Exception:
            pass
        return self.path


def load_flight(path: str) -> dict:
    """Read a flight artifact back; validates the ``kind`` tag so a reader
    can't silently render an unrelated JSON file as a post-mortem."""
    with open(path) as f:
        doc = json.load(f)
    if doc.get("kind") != "flight_recorder":
        raise ValueError(f"{path} is not a flight-recorder dump "
                         f"(kind={doc.get('kind')!r})")
    return doc
