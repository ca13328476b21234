"""Serving — continuous-batching inference over trained LM checkpoints:
the JAX package's ``serving/`` on PyTorch.

The pieces compose bottom-up and each is usable alone:

- ``engine``   slot-based continuous-batching decode engine (``ServingEngine``)
               + the request object (``Request``) + the drive loop
               (``serve_loop``). A request's tokens are the port's
               ``models/generate.generate`` tokens for the same seed.
- ``queue``    bounded admission queue with backpressure and deadline
               shedding (``AdmissionQueue``).
- ``reload``   hot checkpoint reload: poll the train dir like the evaluator,
               swap weights between decode steps (``CheckpointWatcher``).
- ``server``   stdlib ``ThreadingHTTPServer`` JSON front-end
               (``ServingFrontend``) — no new dependencies.
- ``loadgen``  closed/open-loop synthetic load generation reporting
               TTFT / p50 / p99 / tokens-per-sec, plus the SLO sweep
               ladder (``run_slo_sweep``: knee + goodput-under-SLO).
- ``reqtrace`` per-request lifecycle traces in a tail-sampled bounded ring
               (``RequestTraceLog``) — the /debug/requests body and the
               Chrome spans that join request and engine spans.
- ``router``   fleet front-end: replicas self-register in the coordination
               KV (``FleetRegistrar``), the router health-gates them
               (``FleetView``: records ∧ lease freshness ∧ /readyz) and
               load-balances with failover retries, hedged backups, and
               zero-downtime rolling reload (``Router.roll_reload``).

Entry point: ``python -m ps_pytorch_tpu_torch.serve`` (flags in
``config.py``: ``--serve-slots`` / ``--serve-max-queue`` /
``--serve-reload-s`` / ``--slo-spec`` / ``--reqtrace-keep`` ...).
"""

from ps_pytorch_tpu_torch.serving.engine import (Request, ServingEngine,
                                                 serve_loop)
from ps_pytorch_tpu_torch.serving.queue import AdmissionQueue
from ps_pytorch_tpu_torch.serving.reload import CheckpointWatcher
from ps_pytorch_tpu_torch.serving.reqtrace import (RequestTrace,
                                                   RequestTraceLog,
                                                   record_terminal,
                                                   trace_from_request)
from ps_pytorch_tpu_torch.serving.router import (Backend, FleetRegistrar,
                                                 FleetView, Router)

__all__ = ["Request", "ServingEngine", "serve_loop", "AdmissionQueue",
           "CheckpointWatcher", "RequestTrace", "RequestTraceLog",
           "record_terminal", "trace_from_request", "Backend",
           "FleetRegistrar", "FleetView", "Router"]
