"""SLO objectives over sliding windows + multi-window burn-rate alerting:
the JAX package's ``telemetry/slo.py``.

The serving plane's aggregate histograms answer "what happened since boot";
an SLO needs "are we meeting the target RIGHT NOW, and how fast are we
eating the error budget". Three pieces, all clock-injectable so tests drive
them with ``resilience.faults.ManualClock``:

- :func:`parse_slo_spec`: the ``--slo-spec`` grammar, validated at config
  time like ``--fault-spec``/``--health-spec``::

      ttft_p99<100ms;latency_p99<2s;availability>=99.5

  Percentile objectives bind to ``ttft`` / ``latency`` / ``queue_wait``
  (seconds, with ``us``/``ms``/``s`` suffixes); ``availability`` binds to
  the percentage of non-rejected requests that completed.

- :class:`WindowPercentile`: a time-windowed sample reservoir with
  percentile / fraction-over-threshold queries. Deliberately generic — the
  serving SLO tracker uses one per (objective, window), and
  ``telemetry/health.py``'s ``steptime`` watchdog reuses it for a
  step-time-p99 trainer check.

- :class:`SLOTracker`: per-objective fast+slow windows evaluated as burn
  rates (observed violation fraction over the error budget the objective
  allows — a p99 objective budgets 1% of requests over threshold). The
  classic multi-window rule gates alerts on BOTH windows: ``page`` needs
  fast AND slow burn over ``page_burn`` (a recovered incident stops paging
  as soon as the fast window clears), ``warn`` likewise at ``warn_burn``.
  Surfaced as the ``slo_compliance`` / ``slo_burn_rate`` gauges, the
  ``slo_violations_total`` counter, and the front-end's ``/slo`` body.
"""

import re
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Union

# Metrics a percentile objective may bind to, and where summarize()-style
# offline stats dicts carry them (check_slo maps "<metric>_p<q>" to
# "<metric>_p<q>_ms").
PERCENTILE_METRICS = ("ttft", "latency", "queue_wait")

_UNIT_S = {"us": 1e-6, "ms": 1e-3, "s": 1.0, "": 1.0}

_PCTL_RE = re.compile(
    r"^(?P<metric>[a-z_]+)_p(?P<q>[0-9]{1,2}(?:\.[0-9]+)?)"
    r"(?P<op><=|<)(?P<val>[0-9]+(?:\.[0-9]+)?)(?P<unit>us|ms|s)?$")
_AVAIL_RE = re.compile(
    r"^availability(?P<op>>=|>)(?P<val>[0-9]+(?:\.[0-9]+)?)$")


@dataclass(frozen=True)
class SLOObjective:
    """One parsed clause. ``threshold`` is seconds for percentile
    objectives, percent (0–100] for availability."""
    name: str                    # "ttft_p99" | "availability" | ...
    metric: str                  # "ttft" | "latency" | "queue_wait" | "availability"
    percentile: Optional[float]  # 99.0 ... ; None for availability
    op: str                      # "<" | "<=" | ">" | ">="
    threshold: float

    @property
    def budget_frac(self) -> float:
        """The violation fraction the objective tolerates (its error
        budget): 1% for a p99 bound, 0.5% for availability>=99.5."""
        if self.metric == "availability":
            return max(1e-9, (100.0 - self.threshold) / 100.0)
        return max(1e-9, (100.0 - self.percentile) / 100.0)

    def check(self, value: Optional[float]) -> Optional[bool]:
        """Does ``value`` meet the objective? None in → None out."""
        if value is None:
            return None
        if self.op == "<":
            return value < self.threshold
        if self.op == "<=":
            return value <= self.threshold
        if self.op == ">":
            return value > self.threshold
        return value >= self.threshold

    def to_dict(self) -> dict:
        return {"name": self.name, "metric": self.metric,
                "percentile": self.percentile, "op": self.op,
                "threshold": self.threshold}


def parse_slo_spec(spec: str) -> List[SLOObjective]:
    """``"ttft_p99<100ms;latency_p99<2s;availability>=99.5"`` ->
    [SLOObjective]. Raises ValueError on anything malformed so a typo'd SLO
    fails at config time, not mid-incident (the --fault-spec discipline)."""
    out: List[SLOObjective] = []
    seen = set()
    for part in (spec or "").split(";"):
        part = part.strip().replace(" ", "")
        if not part:
            continue
        m = _AVAIL_RE.match(part)
        if m:
            thr = float(m.group("val"))
            if not 0.0 < thr <= 100.0:
                raise ValueError(f"availability threshold {thr} out of "
                                 f"(0, 100] in {part!r}")
            obj = SLOObjective("availability", "availability", None,
                               m.group("op"), thr)
        else:
            m = _PCTL_RE.match(part)
            if m is None:
                raise ValueError(
                    f"bad SLO clause {part!r} (want e.g. 'ttft_p99<100ms' "
                    f"or 'availability>=99.5')")
            metric = m.group("metric")
            if metric not in PERCENTILE_METRICS:
                raise ValueError(
                    f"unknown SLO metric {metric!r} in {part!r} "
                    f"(one of {', '.join(PERCENTILE_METRICS)})")
            q = float(m.group("q"))
            if not 0.0 < q < 100.0:
                raise ValueError(f"percentile p{q:g} out of (0, 100) "
                                 f"in {part!r}")
            thr = float(m.group("val")) * _UNIT_S[m.group("unit") or "s"]
            if thr <= 0:
                raise ValueError(f"threshold must be > 0 in {part!r}")
            obj = SLOObjective(f"{metric}_p{q:g}", metric, q,
                               m.group("op"), thr)
        if obj.name in seen:
            raise ValueError(f"duplicate SLO objective {obj.name!r}")
        seen.add(obj.name)
        out.append(obj)
    return out


class WindowPercentile:
    """Sliding time-window sample reservoir with percentile queries.

    Samples older than ``window_s`` are pruned on every touch; the deque is
    additionally bounded by ``max_samples`` (oldest dropped first) so a
    pathological flood can't grow memory. All queries take ``now=`` so a
    ManualClock test controls time exactly.
    """

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
        q = self._samples
        while q and q[0][0] < horizon:
            q.popleft()

    def observe(self, value: float, now: Optional[float] = None) -> None:
        now = self.clock() if now is None else now
        with self._lock:
            self._prune(now)
            self._samples.append((now, float(value)))

    def count(self, now: Optional[float] = None) -> int:
        now = self.clock() if now is None else now
        with self._lock:
            self._prune(now)
            return len(self._samples)

    def percentile(self, q: float, now: Optional[float] = None,
                   min_n: int = 1) -> Optional[float]:
        """Exact (nearest-rank, interpolated) percentile over the window;
        None below ``min_n`` samples — small windows don't get to claim a
        p99."""
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

    def frac_over(self, threshold: float,
                  now: Optional[float] = None) -> Optional[float]:
        """Fraction of windowed samples strictly above ``threshold`` (None
        when the window is empty) — the burn-rate numerator."""
        now = self.clock() if now is None else now
        with self._lock:
            self._prune(now)
            n = len(self._samples)
            if n == 0:
                return None
            return sum(v > threshold for _, v in self._samples) / n


# Alert states, worst last (max() over indices picks the overall state).
STATES = ("ok", "warn", "page")


class SLOTracker:
    """Evaluates parsed objectives over fast+slow sliding windows.

    Feed it one :meth:`observe_request` per TERMINAL request (any outcome);
    :meth:`evaluate` returns per-objective values, burn rates, and the
    ok/warn/page state, and refreshes the ``slo_compliance`` /
    ``slo_burn_rate`` gauges when a registry is attached.

    Violation bookkeeping per observation: each percentile objective whose
    metric value exceeds its threshold — and the availability objective for
    every shed/failed request — bumps ``slo_violations`` (rendered
    ``slo_violations_total``). Rejected requests are excluded from
    availability entirely (backpressure is the caller's signal, not an
    engine failure), matching ``loadgen.summarize``'s
    ``completed / (requests - rejected)``.
    """

    def __init__(self, spec: Union[str, Sequence[SLOObjective]], *,
                 fast_window_s: float = 60.0, slow_window_s: float = 300.0,
                 warn_burn: float = 1.0, page_burn: float = 2.0,
                 min_samples: int = 10,
                 clock: Callable[[], float] = time.monotonic,
                 registry=None):
        self.objectives = (parse_slo_spec(spec) if isinstance(spec, str)
                           else list(spec))
        if not self.objectives:
            raise ValueError("SLOTracker needs at least one objective")
        if not 0 < fast_window_s <= slow_window_s:
            raise ValueError(f"windows: 0 < fast ({fast_window_s}) <= "
                             f"slow ({slow_window_s})")
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.warn_burn = float(warn_burn)
        self.page_burn = float(page_burn)
        self.min_samples = int(min_samples)
        self.clock = clock
        self.registry = registry
        self.observed = 0
        self.violations = 0
        # One fast+slow reservoir per bound metric. Availability stores a
        # 0/1 "bad" indicator per eligible request, so frac_over(0.5) IS
        # the windowed error rate — one estimator class for everything.
        self._win: Dict[str, Dict[str, WindowPercentile]] = {}
        for obj in self.objectives:
            self._win.setdefault(obj.metric, {
                "fast": WindowPercentile(fast_window_s, clock=clock),
                "slow": WindowPercentile(slow_window_s, clock=clock),
            })
        if registry is not None:
            # declare_serving_metrics already carries these on serving
            # registries; declare only what's missing so a training-side
            # tracker works on a bare registry too.
            have = registry.specs()
            if "slo_compliance" not in have:
                registry.gauge("slo_compliance",
                               help="fraction of SLO objectives met over "
                                    "the slow window (1.0 = all)")
            if "slo_burn_rate" not in have:
                registry.gauge("slo_burn_rate",
                               help="worst per-objective slow-window error-"
                                    "budget burn rate (1.0 = budget exactly)")
            if "slo_violations" not in have:
                registry.counter("slo_violations", unit="events",
                                 help="per-request SLO objective violations")
            registry.set("slo_compliance", 1.0)
            registry.set("slo_burn_rate", 0.0)

    # ---- ingest ----
    def observe_request(self, *, outcome: str = "done",
                        ttft_s: Optional[float] = None,
                        latency_s: Optional[float] = None,
                        queue_wait_s: Optional[float] = None,
                        now: Optional[float] = None) -> int:
        """Record one terminal request; returns how many objectives it
        violated. Latency metrics are only meaningful for ``done`` requests
        (a shed request has no TTFT); availability counts every outcome
        except ``rejected``."""
        now = self.clock() if now is None else now
        vals = {"ttft": ttft_s, "latency": latency_s,
                "queue_wait": queue_wait_s}
        nviol = 0
        for obj in self.objectives:
            wins = self._win[obj.metric]
            if obj.metric == "availability":
                if outcome == "rejected":
                    continue
                bad = 0.0 if outcome == "done" else 1.0
                wins["fast"].observe(bad, now)
                wins["slow"].observe(bad, now)
                if bad:
                    nviol += 1
            else:
                v = vals.get(obj.metric)
                if outcome != "done" or v is None:
                    continue
                wins["fast"].observe(v, now)
                wins["slow"].observe(v, now)
                if obj.check(v) is False:
                    nviol += 1
        self.observed += 1
        if nviol:
            self.violations += nviol
            if self.registry is not None:
                self.registry.inc("slo_violations", nviol)
        return nviol

    # ---- evaluate ----
    def _burn(self, obj: SLOObjective, win: WindowPercentile,
              now: float) -> Optional[float]:
        """Observed violation fraction over the objective's budget; None
        with an empty window."""
        thr = 0.5 if obj.metric == "availability" else obj.threshold
        frac = win.frac_over(thr, now)
        return None if frac is None else frac / obj.budget_frac

    def evaluate(self, now: Optional[float] = None) -> dict:
        """Per-objective values/burns/states + the rolled-up gauges. An
        objective below ``min_samples`` in the slow window reports
        ``compliant: None`` and stays ``ok`` — no data is not an incident."""
        now = self.clock() if now is None else now
        rows = []
        worst = 0
        met = 0
        burn_max = 0.0
        for obj in self.objectives:
            wins = self._win[obj.metric]
            n_fast = wins["fast"].count(now)
            n_slow = wins["slow"].count(now)
            if obj.metric == "availability":
                bad = wins["slow"].frac_over(0.5, now)
                value = None if bad is None else (1.0 - bad) * 100.0
            else:
                value = wins["slow"].percentile(
                    obj.percentile, now, min_n=self.min_samples)
            compliant = (None if n_slow < self.min_samples
                         else obj.check(value))
            bf = self._burn(obj, wins["fast"], now)
            bs = self._burn(obj, wins["slow"], now)
            state = "ok"
            if n_slow >= self.min_samples and bf is not None \
                    and bs is not None:
                if bf >= self.page_burn and bs >= self.page_burn:
                    state = "page"
                elif bf >= self.warn_burn and bs >= self.warn_burn:
                    state = "warn"
                burn_max = max(burn_max, bs)
            worst = max(worst, STATES.index(state))
            if compliant is not False:
                met += 1
            rows.append({**obj.to_dict(), "value": value,
                         "compliant": compliant,
                         "burn_fast": bf, "burn_slow": bs,
                         "samples_fast": n_fast, "samples_slow": n_slow,
                         "state": state})
        compliance = met / len(rows)
        if self.registry is not None:
            self.registry.set("slo_compliance", compliance)
            self.registry.set("slo_burn_rate", burn_max)
        return {"state": STATES[worst], "compliance": compliance,
                "burn_rate": burn_max, "observed": self.observed,
                "violations": self.violations,
                "fast_window_s": self.fast_window_s,
                "slow_window_s": self.slow_window_s,
                "objectives": rows}


def check_slo(stats: Dict, objectives: Sequence[SLOObjective]) -> dict:
    """Evaluate objectives against an OFFLINE ``loadgen.summarize`` stats
    dict (the sweep-ladder compliance check — no windows, the whole rung is
    the sample). A missing/None stat (e.g. percentiles suppressed below the
    minimum sample count) reads as non-compliant: a rung that can't prove
    it met the SLO didn't."""
    rows = []
    ok_all = True
    for obj in objectives:
        if obj.metric == "availability":
            v = stats.get("availability")
            value = None if v is None else v * 100.0
        else:
            ms = stats.get(f"{obj.metric}_p{obj.percentile:g}_ms")
            value = None if ms is None else ms / 1e3
        ok = obj.check(value)
        rows.append({**obj.to_dict(), "value": value, "ok": bool(ok)})
        ok_all = ok_all and bool(ok)
    return {"compliant": ok_all, "objectives": rows}
