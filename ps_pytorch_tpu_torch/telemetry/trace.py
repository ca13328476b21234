"""Host-side span tracer: a copy of the JAX package's ``telemetry/trace.py``.

A nestable context-manager span with monotonic timestamps, recorded into a
thread-safe ring buffer and exported as Chrome ``trace_event`` JSON, so the
host timeline of a step (data wait -> host dispatch -> device sync ->
metrics sync -> checkpoint) opens in Perfetto beside the ``torch.profiler``
device trace.

Two ways in:

- explicit: ``tracer = Tracer(pid=rank)`` and
  ``with tracer.span("data_wait", step=7): ...``; the trainers own one.
- ambient: library layers (``runtime/checkpoint.py``,
  ``runtime/coordinator.py``) call the module-level ``span(...)``, which
  records into the default tracer and does nothing when none is installed.

Spans tagged with ``step=`` also feed a per-step phase accumulator
(``step_summary``): the ``phases`` of the JSONL record and of the
cross-process timeline (``telemetry/aggregate.py``). Host-only code: it
touches no tensor.
"""

import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Dict, List, Optional

# Chrome trace_event "complete" events need ph/ts/dur/pid/tid/name; ts and
# dur are microseconds.
_US = 1e6


class Tracer:
    """Thread-safe ring buffer of completed spans.

    ``capacity`` bounds memory (oldest spans drop; ``dropped`` counts them).
    ``step_window`` bounds the per-step phase accumulator — summaries older
    than the window are discarded, so a million-step run stays O(window).
    """

    def __init__(self, pid: int = 0, process_name: str = "",
                 capacity: int = 65536, step_window: int = 256):
        self.pid = int(pid)
        self.process_name = process_name or f"host{self.pid}"
        self.capacity = max(int(capacity), 1)
        self.dropped = 0
        self._buf: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._step_window = max(int(step_window), 1)
        self._step_totals: Dict[int, Dict[str, float]] = {}
        self._totals: Dict[str, List[float]] = {}  # name -> [count, total_s]

    # ---- recording ----
    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    @contextmanager
    def span(self, name: str, step: Optional[int] = None, **args):
        """Nestable timed region. Nesting depth is carried implicitly by
        start/end containment (Perfetto stacks overlapping same-tid spans).

        Yields the span's mutable args dict — recorded at EXIT, so code
        inside the region can attach facts it only learns mid-span
        (``sargs["corr"] = ...`` for cross-process stitching, byte counts,
        versions) without a second recording API."""
        stack = self._stack()
        stack.append(name)
        t0 = time.monotonic()
        try:
            yield args
        finally:
            t1 = time.monotonic()
            stack.pop()
            self._record(name, t0, t1, step, args)

    def _record(self, name, t0, t1, step, args) -> None:
        dur = t1 - t0
        ev = {"name": name, "t0": t0, "dur": dur,
              "tid": threading.get_ident()}
        if step is not None:
            ev["step"] = int(step)
        if args:
            ev["args"] = args
        with self._lock:
            if len(self._buf) == self.capacity:
                self.dropped += 1
            self._buf.append(ev)
            c = self._totals.setdefault(name, [0, 0.0])
            c[0] += 1
            c[1] += dur
            if step is not None:
                acc = self._step_totals.setdefault(int(step), {})
                acc[name] = acc.get(name, 0.0) + dur
                if len(self._step_totals) > self._step_window:
                    self._step_totals.pop(min(self._step_totals), None)

    # ---- summaries ----
    def step_summary(self, step: int, pop: bool = False) -> Dict[str, float]:
        """{phase name: total seconds} of spans tagged with ``step``."""
        with self._lock:
            acc = (self._step_totals.pop(int(step), {}) if pop
                   else dict(self._step_totals.get(int(step), {})))
        return {k: round(v, 6) for k, v in acc.items()}

    def totals(self) -> Dict[str, dict]:
        """Cumulative {name: {count, total_s}} over the tracer's lifetime
        (not the ring buffer, so it survives wraparound)."""
        with self._lock:
            return {k: {"count": c, "total_s": round(t, 6)}
                    for k, (c, t) in sorted(self._totals.items())}

    def spans(self) -> List[dict]:
        with self._lock:
            return list(self._buf)

    # ---- Chrome trace export ----
    def chrome_events(self) -> List[dict]:
        """trace_event 'X' (complete) events + process metadata, ts in us."""
        events: List[dict] = [
            {"ph": "M", "pid": self.pid, "tid": 0, "name": "process_name",
             "args": {"name": self.process_name}},
        ]
        for ev in self.spans():
            e = {"ph": "X", "pid": self.pid, "tid": ev["tid"],
                 "name": ev["name"], "cat": "host",
                 "ts": round(ev["t0"] * _US, 3),
                 "dur": round(ev["dur"] * _US, 3)}
            args = dict(ev.get("args", {}))
            if "step" in ev:
                args["step"] = ev["step"]
            if args:
                e["args"] = args
            events.append(e)
        return events

    def write_chrome_trace(self, path: str,
                           extra_events: Optional[List[dict]] = None) -> str:
        """Write ``{"traceEvents": [...]}`` (the JSON-object flavor chrome://
        tracing and Perfetto both load). Returns the path written."""
        doc = {"traceEvents": self.chrome_events() + list(extra_events or []),
               "displayTimeUnit": "ms",
               "metadata": {"tracer": "ps_pytorch_tpu_torch.telemetry",
                            "dropped_spans": self.dropped}}
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = f"{path}.tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return path


# ---- ambient tracer (library-layer instrumentation without API churn) ----
_default: Optional[Tracer] = None
_default_lock = threading.Lock()


def set_default_tracer(tracer: Optional[Tracer]) -> Optional[Tracer]:
    """Install (or clear, with None) the process-wide default tracer used by
    the module-level ``span``. Returns the previous one."""
    global _default
    with _default_lock:
        prev = _default
        _default = tracer
    return prev


def get_default_tracer() -> Optional[Tracer]:
    return _default


@contextmanager
def span(name: str, step: Optional[int] = None, **args):
    """Record into the default tracer; a zero-cost no-op when none is set
    (library code stays importable and fast without telemetry wired up).
    With a tracer installed, yields the span's mutable args dict (see
    Tracer.span); without one, yields None — callers guard with
    ``if sargs is not None``."""
    t = _default
    if t is None:
        yield None
    else:
        with t.span(name, step=step, **args) as sargs:
            yield sargs
