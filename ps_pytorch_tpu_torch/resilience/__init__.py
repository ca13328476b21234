"""The resilience planes of the port, copies of the JAX package's
``resilience/``: deterministic fault injection (``faults.py``),
jittered-backoff retries with a budget (``retry.py``), heartbeat liveness
(``heartbeat.py``), crash auto-resume and preemption (``autoresume.py``),
and gradient integrity (``integrity.py``: the wire's chunk digests, the
screen before the sum and the quarantine). A leaf package: stdlib, numpy
and its own modules only (``integrity.py`` reads a tensor it is handed
through torch, imported then).
"""

from ps_pytorch_tpu_torch.resilience.autoresume import (  # noqa: F401
    PreemptionGuard, run_with_auto_resume,
)
from ps_pytorch_tpu_torch.resilience.faults import (  # noqa: F401
    BackendFaultyKV, FaultInjector, FaultyKV, InjectedCrash, ManualClock,
    TransientKVError, corrupt_file, parse_fault_spec,
)
from ps_pytorch_tpu_torch.resilience.heartbeat import (  # noqa: F401
    Heartbeat, LivenessMonitor,
)
from ps_pytorch_tpu_torch.resilience.integrity import (  # noqa: F401
    GradIntegrity, QuarantineManager, contribution_norm, mad_outliers,
    payload_norm, validate_float_leaf, validate_payload, verify_digest,
    wire_digest,
)
from ps_pytorch_tpu_torch.resilience.retry import (  # noqa: F401
    RetryBudget, RetryingKV, RetryPolicy, call_with_retry, is_retryable,
)


def wrap_kv_with(kv, cfg, injector, sleep=None):
    """The JAX package's ``resilience.wrap_kv_with``: the fault plane
    INSIDE the retry plane, so injected transient errors take the path a
    real store hiccup takes. ``injector`` is the caller's (the auto-resume
    loop keeps one across trainer rebuilds, so once-only faults stay
    fired), or None. Returns ``(kv, injector, retrier)``, the retrier None
    when ``kv_retry_attempts`` is 1."""
    if injector is not None:
        kv = injector.wrap_kv(kv)
    retrier = None
    attempts = int(getattr(cfg, "kv_retry_attempts", 1) or 1)
    if attempts > 1:
        policy = RetryPolicy(
            max_attempts=attempts,
            base_s=float(getattr(cfg, "kv_retry_base_s", 0.05)),
            seed=int(getattr(cfg, "seed", 0)))
        budget = int(getattr(cfg, "kv_retry_budget", 0) or 0)
        retrier = RetryingKV(kv, policy,
                             budget=RetryBudget(budget) if budget else None,
                             sleep=sleep)
        kv = retrier
    return kv, injector, retrier
