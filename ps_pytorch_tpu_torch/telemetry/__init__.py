"""The ops plane of the port's trainers, copies of the JAX package's
``telemetry/``: span tracing (``trace.py``), the typed metric registry with
the MFU and goodput arithmetic (``registry.py``), cross-process step
aggregation over the Coordinator's KV (``aggregate.py``), the Prometheus
exposition and exporter (``prometheus.py``), the training-health
watchdogs (``health.py``) and the crash-dump flight recorder
(``flightrec.py``). Host-only code: nothing here reads a tensor but
``device_memory_record``, which reads the CUDA allocator's counters.
The SLO plane and the serving metric declarations are not ported yet
(ROADMAP.md)."""

from ps_pytorch_tpu_torch.telemetry.aggregate import (  # noqa: F401
    TelemetryAggregator, read_timeline,
)
from ps_pytorch_tpu_torch.telemetry.flightrec import (  # noqa: F401
    FlightRecorder, load_flight,
)
from ps_pytorch_tpu_torch.telemetry.health import (  # noqa: F401
    HealthEvent, HealthMonitor, parse_health_spec,
)
from ps_pytorch_tpu_torch.telemetry.prometheus import (  # noqa: F401
    MetricsExporter, parse_exposition, render as render_prometheus,
    sanitize_name,
)
from ps_pytorch_tpu_torch.telemetry.registry import (  # noqa: F401
    ELASTIC_COUNTERS, ELASTIC_GAUGES, HIERARCHY_COUNTERS, HIERARCHY_GAUGES,
    INTEGRITY_COUNTERS, INTEGRITY_GAUGES, KVREP_COUNTERS, KVREP_GAUGES,
    RESILIENCE_COUNTERS, TRAINING_COUNTERS, TRAINING_GAUGES,
    TRAINING_HISTOGRAMS, MetricSpec, Registry, aggregate_peak_flops,
    compute_mfu, data_stall_fraction, declare_elastic_metrics,
    declare_hierarchy_metrics, declare_integrity_metrics,
    declare_kvrep_metrics, declare_resilience_metrics,
    declare_training_metrics, derive_step_record, device_memory_record,
    host_rss_bytes, step_flops_of,
)
from ps_pytorch_tpu_torch.telemetry.trace import (  # noqa: F401
    Tracer, get_default_tracer, set_default_tracer, span,
)
