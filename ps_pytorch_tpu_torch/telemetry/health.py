"""Training-health watchdogs: a copy of the JAX package's
``telemetry/health.py``. Five detectors, configured from one spec string
(``--health-spec``, parsed at config time):

    nonfinite[:action]
        Loss or global grad norm is NaN/Inf. The values come from the
        step's own metrics (``parallel/dp.py`` computes ``grad_norm`` and a
        ``nonfinite`` flag on the device) and are read where the step loop
        already waits for the previous step, so detection adds no device
        sync. ``action=skip`` also turns on the step's gate on the update
        (``TrainStep(skip_nonfinite=True)``): a poisoned step leaves the
        parameters and the optimizer state as they were.
    spike[:action][,factor=10,warmup=20,decay=0.99]
        Grad-norm EWMA spike: after ``warmup`` finite observations, a norm
        above ``factor`` x the EWMA trips.
    divergence[:action][,factor=2,margin=0,warmup=20,decay=0.98]
        Smoothed loss rose above ``best * factor + margin``.
    stall[:action][,factor=10,min_s=5,window=64]
        No step completed for ``max(factor x median step time, min_s)``.
        Evaluated outside the step loop, from the exporter's /healthz
        thread (a wedged loop cannot report itself).
    steptime[:action],p99_s=...[,window_s=60,min_n=20]
        The sliding-window step-time p99 exceeded ``p99_s`` seconds; trips
        on the rising edge only.

Actions: ``warn`` (default: event and counters), ``skip`` (nonfinite
only), ``halt`` (the trainer commits a checkpoint, dumps the flight
recorder and leaves the loop). State surfaces as ``status()`` (the
/healthz body), registry metrics (``health_ok``,
``health_<detector>_trips``) and HealthEvents for the flight recorder.
"""

import math
import statistics
import threading
import time
from collections import deque
from dataclasses import asdict, dataclass, field
from typing import Any, Callable, Dict, List, Optional


class WindowPercentile:
    """Sliding time-window sample reservoir with percentile queries: the
    JAX package's ``telemetry/slo.py:WindowPercentile``, which the
    steptime detector uses (the SLO plane itself is not ported,
    ROADMAP.md). Samples older than ``window_s`` are pruned on every
    touch; at most ``max_samples`` are kept."""

    def __init__(self, window_s: float, *,
                 clock: Callable[[], float] = time.monotonic,
                 max_samples: int = 8192):
        if window_s <= 0:
            raise ValueError(f"window_s={window_s} (need > 0)")
        self.window_s = float(window_s)
        self.clock = clock
        self._samples: deque = deque(maxlen=int(max_samples))
        self._lock = threading.Lock()

    def _prune(self, now: float) -> None:
        horizon = now - self.window_s
        while self._samples and self._samples[0][0] < horizon:
            self._samples.popleft()

    def observe(self, value: float, now: Optional[float] = None) -> None:
        now = self.clock() if now is None else now
        with self._lock:
            self._prune(now)
            self._samples.append((now, float(value)))

    def percentile(self, q: float, now: Optional[float] = None,
                   min_n: int = 1) -> Optional[float]:
        """Interpolated nearest-rank percentile over the window; None
        below ``min_n`` samples."""
        now = self.clock() if now is None else now
        with self._lock:
            self._prune(now)
            vals = sorted(v for _, v in self._samples)
        n = len(vals)
        if n < max(1, min_n):
            return None
        pos = (q / 100.0) * (n - 1)
        lo = int(pos)
        hi = min(lo + 1, n - 1)
        return vals[lo] + (vals[hi] - vals[lo]) * (pos - lo)


DETECTORS = ("nonfinite", "spike", "divergence", "stall", "steptime")
ACTIONS = ("warn", "skip", "halt")

# Per-detector tunables and their defaults; unknown keys fail at parse
# time (config time), same discipline as resilience/faults.py.
_DEFAULTS: Dict[str, Dict[str, float]] = {
    "nonfinite": {},
    "spike": {"factor": 10.0, "warmup": 20, "decay": 0.99},
    "divergence": {"factor": 2.0, "margin": 0.0, "warmup": 20,
                   "decay": 0.98},
    "stall": {"factor": 10.0, "min_s": 5.0, "window": 64},
    "steptime": {"p99_s": 0.0, "window_s": 60.0, "min_n": 20},
}


def parse_health_spec(spec: str) -> List[Dict[str, Any]]:
    """``"detector[:action][,k=v...];..."`` -> [{"detector", "action",
    **params}]. Raises ValueError on unknown detectors/actions/params so a
    typo'd watchdog fails at config time, not mid-incident."""
    out: List[Dict[str, Any]] = []
    seen = set()
    for part in (spec or "").split(";"):
        part = part.strip()
        if not part:
            continue
        # "det[:action][,k=v...]" — the comma split comes first so params
        # are accepted with or without an explicit action.
        head, _, rest = part.split(",", 1)[0].partition(":")
        rest = ",".join([rest] + part.split(",")[1:])
        det = head.strip()
        if det not in DETECTORS:
            raise ValueError(f"unknown health detector {det!r} "
                             f"(one of {', '.join(DETECTORS)})")
        if det in seen:
            raise ValueError(f"duplicate health detector {det!r}")
        seen.add(det)
        entry: Dict[str, Any] = {"detector": det, "action": "warn"}
        entry.update(_DEFAULTS[det])
        for tok in rest.split(","):
            tok = tok.strip()
            if not tok:
                continue
            k, sep, v = tok.partition("=")
            if not sep:
                if tok not in ACTIONS:
                    raise ValueError(f"unknown health action {tok!r} in "
                                     f"{part!r} (one of {', '.join(ACTIONS)})")
                entry["action"] = tok
                continue
            k = k.strip()
            if k not in _DEFAULTS[det]:
                raise ValueError(
                    f"unknown param {k!r} for detector {det!r} in {part!r} "
                    f"(have {sorted(_DEFAULTS[det]) or 'none'})")
            try:
                entry[k] = float(v.strip())
            except ValueError:
                raise ValueError(f"health param {tok!r} is not numeric "
                                 f"(in {part!r})") from None
        if entry["action"] == "skip" and det != "nonfinite":
            # skip is the step's gate on the update; only the nonfinite
            # flag exists inside the step.
            raise ValueError(f"action 'skip' is only valid for 'nonfinite' "
                             f"(got {part!r})")
        if det == "steptime" and entry["p99_s"] <= 0:
            raise ValueError(f"steptime needs p99_s > 0 (got {part!r}); "
                             "there is no sane default step-time bound")
        out.append(entry)
    return out


@dataclass
class HealthEvent:
    """One watchdog trip — what the flight recorder and /healthz carry."""
    detector: str
    action: str
    step: int
    value: float
    threshold: float
    message: str
    t: float = field(default_factory=time.time)   # wall clock, for dumps

    def to_dict(self) -> dict:
        return asdict(self)


class HealthMonitor:
    """Owns the parsed spec, the detector state, and the trip log.

    Thread-safety model: ``observe_step``/``beat`` run on the step-loop
    thread; ``check_stall``/``status`` may run concurrently on the
    exporter's HTTP threads. Shared state is written with plain attribute
    stores (atomic in CPython) and read-only scans; the events list is a
    bounded deque (appends are atomic too).
    """

    def __init__(self, spec: str, registry=None,
                 clock: Callable[[], float] = time.monotonic):
        self.spec = spec
        self.checks = parse_health_spec(spec)
        self._by_det = {c["detector"]: c for c in self.checks}
        self.clock = clock
        self.registry = registry
        self.events: deque = deque(maxlen=256)
        self.trips: Dict[str, int] = {c["detector"]: 0 for c in self.checks}
        self.should_halt = False
        self.halt_event: Optional[HealthEvent] = None
        # Detector state.
        self._gn_ewma: Optional[float] = None
        self._gn_seen = 0
        self._loss_ewma: Optional[float] = None
        self._loss_best: Optional[float] = None
        self._loss_seen = 0
        self._step_times: deque = deque(
            maxlen=int(self._by_det.get("stall", {}).get("window", 64)))
        st = self._by_det.get("steptime")
        self._steptime_win = (None if st is None else WindowPercentile(
            st["window_s"], clock=clock))
        self._steptime_high = False
        self._last_progress = clock()
        self._stalled = False
        self.last_step = 0
        if registry is not None:
            registry.gauge("health_ok", help="1 while no watchdog demands a "
                                             "halt and the loop is alive")
            registry.set("health_ok", 1.0)
            for c in self.checks:
                registry.counter(f"health_{c['detector']}_trips",
                                 unit="events",
                                 help=f"{c['detector']} watchdog trips "
                                      f"(action={c['action']})")

    # ---- configuration queries ----
    @property
    def skip_nonfinite(self) -> bool:
        """True when the nonfinite detector's action is the skip
        (make_train_step's ``skip_nonfinite`` switch)."""
        c = self._by_det.get("nonfinite")
        return bool(c) and c["action"] == "skip"

    # ---- event plumbing ----
    def _trip(self, det: str, step: int, value: float, threshold: float,
              message: str) -> HealthEvent:
        c = self._by_det[det]
        ev = HealthEvent(det, c["action"], int(step), float(value),
                         float(threshold), message)
        self.events.append(ev)
        self.trips[det] += 1
        if self.registry is not None:
            self.registry.inc(f"health_{det}_trips")
        if c["action"] == "halt" and not self.should_halt:
            self.should_halt = True
            self.halt_event = ev
            if self.registry is not None:
                self.registry.set("health_ok", 0.0)
        return ev

    # ---- step-loop surface ----
    def beat(self, now: Optional[float] = None) -> None:
        """Mark liveness without a step (serving loop, idle waits)."""
        self._last_progress = self.clock() if now is None else now
        self._stalled = False

    def observe_step(self, step: int, *, loss: Optional[float] = None,
                     grad_norm: Optional[float] = None,
                     nonfinite: Optional[float] = None,
                     step_time: Optional[float] = None,
                     now: Optional[float] = None) -> List[HealthEvent]:
        """Feed one completed step's host-materialized values; returns the
        events tripped by it (possibly empty). ``nonfinite`` is the
        step's own flag when it provides one; loss/grad_norm are also
        checked host-side so callers without the flag still get coverage."""
        events: List[HealthEvent] = []
        step = int(step)
        self.last_step = max(self.last_step, step)
        self.beat(now)
        if step_time is not None and step_time > 0:
            self._step_times.append(float(step_time))
            if self._steptime_win is not None:
                c = self._by_det["steptime"]
                self._steptime_win.observe(float(step_time), now)
                p99 = self._steptime_win.percentile(
                    99.0, now, min_n=int(c["min_n"]))
                if p99 is not None and p99 > c["p99_s"]:
                    if not self._steptime_high:
                        self._steptime_high = True
                        events.append(self._trip(
                            "steptime", step, p99, c["p99_s"],
                            f"windowed step-time p99 {p99:.4g}s > "
                            f"{c['p99_s']:g}s at step {step}"))
                else:
                    self._steptime_high = False

        bad = bool(nonfinite)
        for v in (loss, grad_norm):
            if v is not None and not math.isfinite(v):
                bad = True
        if bad and "nonfinite" in self._by_det:
            events.append(self._trip(
                "nonfinite", step, float("nan"), float("nan"),
                f"non-finite loss/grad at step {step} "
                f"(loss={loss}, grad_norm={grad_norm})"))

        if grad_norm is not None and math.isfinite(grad_norm) \
                and "spike" in self._by_det:
            c = self._by_det["spike"]
            if self._gn_seen >= c["warmup"] and self._gn_ewma is not None \
                    and self._gn_ewma > 0:
                thr = c["factor"] * self._gn_ewma
                if grad_norm > thr:
                    events.append(self._trip(
                        "spike", step, grad_norm, thr,
                        f"grad_norm {grad_norm:.4g} > {c['factor']:g}x "
                        f"EWMA {self._gn_ewma:.4g} at step {step}"))
            d = c["decay"]
            self._gn_ewma = (grad_norm if self._gn_ewma is None
                             else d * self._gn_ewma + (1 - d) * grad_norm)
            self._gn_seen += 1

        if loss is not None and math.isfinite(loss) \
                and "divergence" in self._by_det:
            c = self._by_det["divergence"]
            d = c["decay"]
            self._loss_ewma = (loss if self._loss_ewma is None
                               else d * self._loss_ewma + (1 - d) * loss)
            self._loss_seen += 1
            if self._loss_seen >= c["warmup"]:
                if self._loss_best is None:
                    self._loss_best = self._loss_ewma
                thr = self._loss_best * c["factor"] + c["margin"]
                if self._loss_ewma > thr:
                    events.append(self._trip(
                        "divergence", step, self._loss_ewma, thr,
                        f"smoothed loss {self._loss_ewma:.4g} > "
                        f"{thr:.4g} (best {self._loss_best:.4g}) "
                        f"at step {step}"))
                self._loss_best = min(self._loss_best, self._loss_ewma)
        return events

    # ---- out-of-loop surface (exporter threads) ----
    def check_stall(self, now: Optional[float] = None) -> Optional[HealthEvent]:
        """Trip the stall detector when no progress landed for
        ``max(factor x median step time, min_s)``. Re-arms on the next
        beat/observe_step. Safe to call from any thread, any cadence."""
        c = self._by_det.get("stall")
        if c is None or self._stalled:
            return None
        now = self.clock() if now is None else now
        idle = now - self._last_progress
        if len(self._step_times) >= 5:
            deadline = max(c["factor"] * statistics.median(self._step_times),
                           c["min_s"])
        else:
            deadline = max(c["min_s"], 1.0)
        if idle <= deadline:
            return None
        self._stalled = True
        return self._trip(
            "stall", self.last_step, idle, deadline,
            f"no progress for {idle:.2f}s (deadline {deadline:.2f}s) "
            f"after step {self.last_step}")

    @property
    def ok(self) -> bool:
        return not self.should_halt and not self._stalled

    def status(self) -> dict:
        """The /healthz body: evaluates the stall detector, then reports
        every detector's trip count plus the recent event tail."""
        self.check_stall()
        return {
            "ok": self.ok,
            "halted": self.should_halt,
            "halt_reason": (self.halt_event.message
                            if self.halt_event else None),
            "stalled": self._stalled,
            "last_step": self.last_step,
            "detectors": {c["detector"]: {"action": c["action"],
                                          "trips": self.trips[c["detector"]]}
                          for c in self.checks},
            "events": [ev.to_dict() for ev in list(self.events)[-8:]],
        }
