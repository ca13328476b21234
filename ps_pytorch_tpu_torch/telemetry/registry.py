"""Typed metric registry and the derived per-step record: the JAX
package's ``telemetry/registry.py`` (``MetricSpec``, ``Registry``
``:34-192``, the serving and router contracts ``:366-455``, the training
contract ``:485-520``, the derived arithmetic ``:523-603``).

- ``mfu``: the model's FLOPs a step (``utils/flops.py``) over the step's
  wall time and the cards' aggregate dense bf16 peak
  (``utils/flops.peak_flops_bf16``), whatever the compute type, as the
  JAX package divides it. Null where the peak or the count is unknown
  (the CPU), never 0.
- ``examples_per_sec`` (and ``tokens_per_sec`` for the LM): the global
  batch over the step's wall time.
- ``data_stall_frac``: the share of the step spent waiting on the loader.
- device memory: the CUDA caching allocator's own peak and current
  allocated bytes (``torch.cuda.memory_stats``), absent on the CPU.

Metrics must be declared (name, kind, unit, help) before use, so the set
of emitted names is a reviewable contract. The resilience, integrity,
replicated-KV, hierarchy, elastic, serving and router metrics are
declared here too (the JAX package's names, units and kinds).
"""

import threading
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

# Latency-style default buckets: sub-ms to minutes, roughly x2 a bucket.
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0)


@dataclass(frozen=True)
class MetricSpec:
    name: str
    kind: str          # "counter" (monotonic) | "gauge" (set) | "histogram"
    unit: str = ""
    help: str = ""
    buckets: Tuple[float, ...] = ()     # histogram upper bounds, ascending

    def __post_init__(self):
        if self.kind not in ("counter", "gauge", "histogram"):
            raise ValueError(f"metric kind {self.kind!r} "
                             "(counter | gauge | histogram)")
        if self.kind == "histogram":
            bs = tuple(float(b) for b in (self.buckets or DEFAULT_BUCKETS))
            if list(bs) != sorted(bs) or len(set(bs)) != len(bs):
                raise ValueError(f"histogram {self.name!r} buckets must be "
                                 "strictly ascending")
            object.__setattr__(self, "buckets", bs)


class Registry:
    """Declared-metrics store of host floats. ``inc`` only on counters,
    ``set`` only on gauges, ``observe`` only on histograms; an undeclared
    name raises. Thread-safe: the exporter's HTTP threads read it while
    the step loop writes."""

    def __init__(self):
        self._specs: Dict[str, MetricSpec] = {}
        self._values: Dict[str, float] = {}
        self._hists: Dict[str, dict] = {}
        self._lock = threading.Lock()

    def counter(self, name: str, unit: str = "", help: str = "") -> str:
        return self._declare(MetricSpec(name, "counter", unit, help))

    def gauge(self, name: str, unit: str = "", help: str = "") -> str:
        return self._declare(MetricSpec(name, "gauge", unit, help))

    def histogram(self, name: str, unit: str = "", help: str = "",
                  buckets: Optional[Tuple[float, ...]] = None) -> str:
        return self._declare(
            MetricSpec(name, "histogram", unit, help, tuple(buckets or ())))

    def _declare(self, spec: MetricSpec) -> str:
        with self._lock:
            old = self._specs.get(spec.name)
            if old is not None and old != spec:
                raise ValueError(f"metric {spec.name!r} re-declared as "
                                 f"{spec.kind}, was {old.kind}")
            self._specs[spec.name] = spec
            if spec.kind == "histogram":
                self._hists.setdefault(spec.name, {
                    # counts[i] = observations in bucket i; last = +Inf
                    "counts": [0] * (len(spec.buckets) + 1),
                    "sum": 0.0, "count": 0, "min": None, "max": None,
                })
            else:
                self._values.setdefault(spec.name, 0.0)
        return spec.name

    def _spec(self, name: str, kind: str) -> MetricSpec:
        spec = self._specs.get(name)
        if spec is None:
            raise KeyError(f"metric {name!r} not declared")
        if spec.kind != kind:
            raise TypeError(f"metric {name!r} is a {spec.kind}, not a {kind}")
        return spec

    def inc(self, name: str, value: float = 1.0) -> float:
        self._spec(name, "counter")
        if value < 0:
            raise ValueError(f"counter {name!r} cannot decrease")
        with self._lock:
            self._values[name] += value
            return self._values[name]

    def set(self, name: str, value: float) -> float:
        self._spec(name, "gauge")
        with self._lock:
            self._values[name] = float(value)
            return self._values[name]

    def observe(self, name: str, value: float) -> None:
        spec = self._spec(name, "histogram")
        v = float(value)
        with self._lock:
            h = self._hists[name]
            i = 0
            while i < len(spec.buckets) and v > spec.buckets[i]:
                i += 1
            h["counts"][i] += 1
            h["sum"] += v
            h["count"] += 1
            h["min"] = v if h["min"] is None else min(h["min"], v)
            h["max"] = v if h["max"] is None else max(h["max"], v)

    def _quantile_locked(self, spec: MetricSpec, h: dict, q: float) -> float:
        """Prometheus-style bucket interpolation, clamped to the observed
        [min, max]."""
        rank = q * h["count"]
        seen = 0
        for i, c in enumerate(h["counts"]):
            if c == 0:
                continue
            if seen + c >= rank:
                lo = spec.buckets[i - 1] if i > 0 else 0.0
                hi = spec.buckets[i] if i < len(spec.buckets) else h["max"]
                est = lo + (hi - lo) * (rank - seen) / c
                return min(max(est, h["min"]), h["max"])
            seen += c
        return h["max"]

    def hist_summary(self, name: str) -> dict:
        """{"count", "sum", "min", "max", "p50", "p99"}; an empty histogram
        gives count 0 and None elsewhere."""
        spec = self._spec(name, "histogram")
        with self._lock:
            h = self._hists[name]
            if h["count"] == 0:
                return {"count": 0, "sum": 0.0, "min": None, "max": None,
                        "p50": None, "p99": None}
            return {"count": h["count"], "sum": h["sum"],
                    "min": h["min"], "max": h["max"],
                    "p50": self._quantile_locked(spec, h, 0.50),
                    "p99": self._quantile_locked(spec, h, 0.99)}

    def hist_counts(self, name: str) -> list:
        """Per-bucket counts of a histogram, the last one +Inf's."""
        self._spec(name, "histogram")
        with self._lock:
            return list(self._hists[name]["counts"])

    def get(self, name: str) -> float:
        with self._lock:
            if name not in self._specs:
                raise KeyError(f"metric {name!r} not declared")
            return self._values[name]

    def snapshot(self) -> Dict[str, object]:
        """Counters and gauges as floats; each histogram as its summary."""
        with self._lock:
            out: Dict[str, object] = dict(self._values)
        for name, spec in self.specs().items():
            if spec.kind == "histogram":
                out[name] = self.hist_summary(name)
        return out

    def specs(self) -> Dict[str, MetricSpec]:
        with self._lock:
            return dict(self._specs)


# ---- the trainers' metric contract ----
# Names mirror the JSONL fields, so a dashboard and a post-hoc analysis
# read the same vocabulary.
TRAINING_COUNTERS = (
    ("train_steps", "steps", "training steps completed"),
)
TRAINING_GAUGES = (
    ("train_step", "step", "current training step"),
    ("train_loss", "", "last step's training loss"),
    ("train_grad_norm", "", "last step's global gradient norm"),
    ("train_step_time_s", "s", "last step's wall time"),
    ("train_data_time_s", "s", "last step's input-pipeline wait"),
    ("train_examples_per_sec", "examples/s", "last step's goodput"),
    ("device_mem_peak_bytes", "bytes",
     "device HBM peak bytes in use (0 when the backend has no stats)"),
    ("device_mem_bytes", "bytes",
     "device HBM bytes in use (0 when the backend has no stats)"),
    ("host_rss_bytes", "bytes", "host process peak RSS watermark"),
)
TRAINING_HISTOGRAMS = (
    ("train_step_latency_s", "s", "per-step wall-time distribution"),
)


def declare_training_metrics(registry: Registry) -> Registry:
    """Declare the trainers' counters, gauges and histograms."""
    for name, unit, help_ in TRAINING_COUNTERS:
        registry.counter(name, unit=unit, help=help_)
    for name, unit, help_ in TRAINING_GAUGES:
        registry.gauge(name, unit=unit, help=help_)
    for name, unit, help_ in TRAINING_HISTOGRAMS:
        registry.histogram(name, unit=unit, help=help_)
    return registry


# The resilience counters (resilience/): the fault plane's, the retry
# plane's and the liveness monitor's, the JAX package's names. A trainer
# declares them when a fault or retry plane is on, and its exporter pumps
# them from the live snapshots.
RESILIENCE_COUNTERS = (
    ("kv_drops", "ops", "injected KV drops raised as transient errors"),
    ("kv_delays", "ops", "injected KV delays applied"),
    ("crashes", "events", "injected replica crashes fired"),
    ("ckpt_corruptions", "events",
     "injected post-commit checkpoint corruptions"),
    ("grad_nans", "events", "injected NaN-gradient steps"),
    ("kv_retries", "ops", "KV ops retried after a transient error"),
    ("kv_giveups", "ops", "KV ops failed after retries/budget ran out"),
    ("evictions", "events", "replicas evicted for missed heartbeats"),
    ("readmissions", "events", "evicted replicas readmitted on recovery"),
    ("mask_changes", "events", "leader participation-mask changes"),
    ("leader_kills", "events", "injected leader SIGKILLs fired"),
    ("kv_partition_drops", "ops",
     "KV ops dropped inside an injected partition window"),
    ("link_jitters", "ops", "injected per-link KV delays applied"),
    ("payload_bitflips", "ops",
     "injected in-alphabet chunk corruptions on KV reads"),
    ("payload_truncates", "ops", "injected torn-read chunk truncations"),
    ("grad_poisons", "steps",
     "steps where an injected grad_poison window scaled local gradients"),
    ("kv_backend_kills", "events",
     "injected kv_backend_kill outage windows opened"),
    ("kv_backend_wipes", "events",
     "injected kv_backend_wipe keyspace losses fired"),
    ("kv_backend_drops", "ops",
     "single-backend ops dropped inside a kv_backend_kill window"),
)


def declare_resilience_metrics(registry: Registry) -> Registry:
    """Declare every resilience counter on ``registry`` (all monotonic)."""
    for name, unit, help_ in RESILIENCE_COUNTERS:
        registry.counter(name, unit=unit, help=help_)
    return registry


# ---- gradient-integrity contract (resilience/integrity.py) ----
#
# wire_integrity_failures comes from the transport's channels (digest,
# decode and meta demotions); the rest from the leader's GradIntegrity
# screen. Counters are cumulative (rendered with _total);
# quarantined-now is a gauge.
INTEGRITY_COUNTERS = (
    ("wire_integrity_failures", "reads",
     "channel reads demoted for digest mismatch / corrupt armour / torn "
     "meta"),
    ("integrity_screen_rejects", "contributions",
     "contributions rejected by the compressed-domain payload validators"),
    ("integrity_outlier_rejects", "contributions",
     "contributions rejected by the cross-contributor MAD outlier gate"),
    ("integrity_strikes", "events",
     "screened-out contributions charged to a contributor"),
    ("integrity_quarantines", "events",
     "contributors quarantined after reaching the strike limit"),
    ("integrity_readmissions", "events",
     "quarantined contributors readmitted on probation after clean "
     "screens"),
)
INTEGRITY_GAUGES = (
    ("integrity_quarantined", "contributors",
     "contributors currently quarantined"),
)


def declare_integrity_metrics(registry: Registry) -> Registry:
    """Declare the gradient-integrity counters and gauge on ``registry``."""
    for name, unit, help_ in INTEGRITY_COUNTERS:
        registry.counter(name, unit=unit, help=help_)
    for name, unit, help_ in INTEGRITY_GAUGES:
        registry.gauge(name, unit=unit, help=help_)
    return registry


# ---- replicated-KV contract (runtime/kvrep.py) -------------
#
# The quorum-replicated coordination plane's reviewable surface: quorum
# failures the retry plane saw, per-backend error/ejection/rejoin
# lifecycle, steady-state read-repair traffic, and anti-entropy resync
# volume — plus the two gauges a dashboard needs to see a degraded
# replica set AT A GLANCE.
KVREP_COUNTERS = (
    ("kvrep_quorum_failures", "ops",
     "logical KV ops that failed to reach a write/read quorum"),
    ("kvrep_backend_errors", "ops",
     "single-backend op failures absorbed below the quorum"),
    ("kvrep_ejections", "events",
     "backends ejected after consecutive failures"),
    ("kvrep_rejoins", "events",
     "ejected backends readmitted after probe + anti-entropy resync"),
    ("kvrep_read_repairs", "ops",
     "stale/absent replica copies overwritten during quorum reads"),
    ("kvrep_resyncs", "events", "anti-entropy resync passes completed"),
    ("kvrep_resync_keys", "keys",
     "replica copies repaired by anti-entropy resync"),
    ("kvrep_probes", "events", "probation probes sent to ejected backends"),
)
KVREP_GAUGES = (
    ("kvrep_backends", "backends", "configured KV replica backends"),
    ("kvrep_backends_healthy", "backends",
     "KV replica backends currently in the quorum set"),
)


def declare_kvrep_metrics(registry: Registry) -> Registry:
    """Declare the replicated-KV counters/gauges on ``registry``."""
    for name, unit, help_ in KVREP_COUNTERS:
        registry.counter(name, unit=unit, help=help_)
    for name, unit, help_ in KVREP_GAUGES:
        registry.gauge(name, unit=unit, help=help_)
    return registry


# ---- hierarchical sync (parallel/hierarchy.py): per-hop traffic, the
# subtree partition / regraft lifecycle, aggregator failovers and the group
# health gauges (the JAX package's names, units and kinds) ----
HIERARCHY_COUNTERS = (
    ("hierarchy_hops", "ops", "aggregation hops completed (any tier)"),
    ("hierarchy_group_publishes", "ops",
     "group aggregates re-encoded and published upward"),
    ("hierarchy_partitions", "events",
     "subtrees declared partitioned (went stale past the limit)"),
    ("hierarchy_regrafts", "events",
     "partitioned subtrees re-grafted after healing"),
    ("hierarchy_degraded_steps", "steps",
     "root updates applied with at least one subtree missing"),
    ("hierarchy_failovers", "events",
     "group aggregator roles adopted by another member"),
)
HIERARCHY_GAUGES = (
    ("hierarchy_groups", "groups", "sync groups in the topology"),
    ("hierarchy_groups_healthy", "groups",
     "groups contributing within the staleness limit"),
)


def declare_hierarchy_metrics(registry: Registry) -> Registry:
    """Declare the hierarchical-sync counters/gauges on ``registry``."""
    for name, unit, help_ in HIERARCHY_COUNTERS:
        registry.counter(name, unit=unit, help=help_)
    for name, unit, help_ in HIERARCHY_GAUGES:
        registry.gauge(name, unit=unit, help=help_)
    return registry


# ---- elastic control-plane contract (elastic/) ----
#
# Same discipline: the reviewable list of what the election/membership
# planes surface. leader_epoch and world_size are GAUGES (the epoch is
# monotonic but a freshly-promoted process starts from the observed value,
# not zero); membership_changes/elections are cumulative counters, so the
# Prometheus exposition renders them with the _total suffix.
ELASTIC_COUNTERS = (
    ("membership_changes", "events",
     "membership-epoch bumps (joins, leaves, evictions folded in)"),
    ("elections", "events", "leader campaigns run after a stale lease"),
)
ELASTIC_GAUGES = (
    ("leader_epoch", "epoch", "current leader-lease epoch"),
    ("world_size", "processes", "active members in the current view"),
)


def declare_elastic_metrics(registry: Registry) -> Registry:
    """Declare the elastic counters/gauges on ``registry``."""
    for name, unit, help_ in ELASTIC_COUNTERS:
        registry.counter(name, unit=unit, help=help_)
    for name, unit, help_ in ELASTIC_GAUGES:
        registry.gauge(name, unit=unit, help=help_)
    return registry


# ---- serving metric contract (serving/) ----
#
# Same discipline as RESILIENCE_COUNTERS: the one reviewable list of what
# the serving plane emits. Counters/gauges are (name, unit, help);
# histograms observe seconds with the DEFAULT_BUCKETS latency ladder.
SERVING_COUNTERS = (
    ("serve_requests", "requests", "requests completed"),
    ("serve_tokens", "tokens", "tokens sampled across all requests"),
    ("serve_rejected", "requests", "requests rejected at admission (queue full)"),
    ("serve_shed", "requests", "requests shed for a passed deadline"),
    ("serve_reloads", "events", "hot checkpoint reloads applied"),
    ("serve_resolve_races", "events", "terminal resolutions that lost the "
                                      "first-wins CAS (double-resolve "
                                      "attempts suppressed)"),
    ("serve_rejected_oversize", "requests", "requests rejected for an "
                                            "oversized or malformed body"),
    ("slo_violations", "events", "per-request SLO objective violations"),
)
SERVING_GAUGES = (
    ("serve_active_slots", "slots", "decode slots currently occupied"),
    ("serve_queue_depth", "requests", "admission queue depth"),
    ("serve_model_step", "step", "checkpoint step currently served"),
    ("slo_compliance", "", "fraction of SLO objectives met over the "
                           "slow window (1.0 = all)"),
    ("slo_burn_rate", "", "worst per-objective slow-window error-budget "
                          "burn rate (1.0 = budget exactly)"),
)
SERVING_HISTOGRAMS = (
    ("serve_request_latency_s", "s", "submit -> last token latency"),
    ("serve_ttft_s", "s", "submit -> first token latency (TTFT)"),
    ("serve_queue_wait_s", "s", "submit -> admission queue wait"),
)


def declare_serving_metrics(registry: Registry) -> Registry:
    """Declare the serving counters/gauges/histograms on ``registry``."""
    for name, unit, help_ in SERVING_COUNTERS:
        registry.counter(name, unit=unit, help=help_)
    for name, unit, help_ in SERVING_GAUGES:
        registry.gauge(name, unit=unit, help=help_)
    for name, unit, help_ in SERVING_HISTOGRAMS:
        registry.histogram(name, unit=unit, help=help_)
    return registry


# ---- router metric contract (serving/router.py) ----
#
# The fleet front-end's view: routed request outcomes, failover retries,
# hedged backups, and backend health transitions. Routed availability
# (router_requests vs router_failed) is what the SLO burn-rate engine
# consumes at the router — the client-visible number, not any one
# replica's.
ROUTER_COUNTERS = (
    ("router_requests", "requests", "requests routed to completion"),
    ("router_failed", "requests", "requests that exhausted retries and "
                                  "surfaced an error to the client"),
    ("router_retries", "attempts", "failover re-dispatches to a different "
                                   "replica after a retryable failure"),
    ("router_hedges", "requests", "hedged backup requests issued past the "
                                  "tail-latency threshold"),
    ("router_hedge_wins", "requests", "hedged backups that beat the "
                                      "primary attempt"),
    ("router_hedge_cancelled", "requests", "hedge losers cancelled after "
                                           "the first response won"),
    ("router_backend_ejections", "events", "backends marked unhealthy "
                                           "(probe/lease/forward failure)"),
)
ROUTER_GAUGES = (
    ("router_backends_ready", "replicas", "backends currently health-gated "
                                          "ready"),
    ("router_outstanding", "requests", "requests in flight across all "
                                       "backends"),
)
ROUTER_HISTOGRAMS = (
    ("router_request_latency_s", "s", "routed submit -> response latency "
                                      "(includes retries and hedges)"),
)


def declare_router_metrics(registry: Registry) -> Registry:
    """Declare the router counters/gauges/histograms on ``registry``."""
    for name, unit, help_ in ROUTER_COUNTERS:
        registry.counter(name, unit=unit, help=help_)
    for name, unit, help_ in ROUTER_GAUGES:
        registry.gauge(name, unit=unit, help=help_)
    for name, unit, help_ in ROUTER_HISTOGRAMS:
        registry.histogram(name, unit=unit, help=help_)
    return registry


def host_rss_bytes() -> int:
    """Peak resident-set watermark of this process (getrusage; KiB on
    Linux, bytes on macOS); 0 where the platform has neither."""
    try:
        import resource
        import sys
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        return int(rss if sys.platform == "darwin" else rss * 1024)
    except (ImportError, OSError):
        return 0


def compute_mfu(flops_per_step: Optional[int], step_time_s: float,
                peak_flops_per_chip: Optional[float],
                n_chips: int = 1) -> Optional[float]:
    """Model FLOPs utilization: FLOPs / (step time * peak * chips). None,
    not 0, whenever an input is unknown."""
    if not flops_per_step or flops_per_step <= 0 or step_time_s <= 0:
        return None
    if not peak_flops_per_chip or n_chips <= 0:
        return None
    return flops_per_step / (step_time_s * peak_flops_per_chip * n_chips)


def data_stall_fraction(data_time_s: float,
                        step_time_s: float) -> Optional[float]:
    """Share of the step spent waiting on the loader, clamped to [0, 1]."""
    if step_time_s <= 0:
        return None
    return max(0.0, min(1.0, data_time_s / step_time_s))


def device_memory_record(device=None) -> dict:
    """{"device_mem_peak_bytes", "device_mem_bytes"}: the caching
    allocator's ``allocated_bytes.all.peak`` and ``.current`` of a CUDA
    ``device``, host-side counters (reading them waits for nothing on the
    card); {} for any other device, so a CPU record has the JAX package's
    CPU keys."""
    if device is None or torch.device(device).type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    out = {}
    if "allocated_bytes.all.peak" in stats:
        out["device_mem_peak_bytes"] = int(stats["allocated_bytes.all.peak"])
    if "allocated_bytes.all.current" in stats:
        out["device_mem_bytes"] = int(stats["allocated_bytes.all.current"])
    return out


def derive_step_record(*, step_time_s: float, data_time_s: float = 0.0,
                       examples: Optional[int] = None,
                       tokens: Optional[int] = None,
                       flops_per_step: Optional[int] = None,
                       peak_flops_per_chip: Optional[float] = None,
                       n_chips: int = 1, device=None,
                       with_memory: bool = True) -> dict:
    """The schema-v2 derived fields of one step: always ``mfu``,
    ``examples_per_sec`` and ``data_stall_frac`` (None where they cannot
    be computed); ``tokens_per_sec`` and the device-memory fields where
    they exist."""
    mfu = compute_mfu(flops_per_step, step_time_s, peak_flops_per_chip,
                      n_chips)
    stall = data_stall_fraction(data_time_s, step_time_s)
    rec = {
        "mfu": None if mfu is None else round(mfu, 6),
        "examples_per_sec": (round(examples / step_time_s, 2)
                             if examples and step_time_s > 0 else None),
        "data_stall_frac": None if stall is None else round(stall, 4),
    }
    if tokens and step_time_s > 0:
        rec["tokens_per_sec"] = round(tokens / step_time_s, 1)
    if with_memory:
        rec.update(device_memory_record(device))
    return rec


def step_flops_of(cfg, batch: Optional[int] = None, groups: int = 1) -> int:
    """The model's FLOPs a training step of ``cfg`` at the global batch
    (``utils/flops.training_flops``; ``groups``: the MoE LM's capacity
    groups): counted on the ``meta`` device, once, and divided by every
    step's time."""
    from ps_pytorch_tpu_torch.utils.flops import training_flops
    return training_flops(cfg, batch, groups)


def aggregate_peak_flops(device) -> Optional[float]:
    """Peak dense bf16 FLOP/s of one card of ``device``'s kind; None off
    CUDA and for a card the peak table does not know."""
    from ps_pytorch_tpu_torch.utils.flops import peak_flops_bf16
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return peak_flops_bf16(torch.cuda.get_device_name(device))
