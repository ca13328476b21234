"""The resilience planes of the port: jittered-backoff retries with a
budget (``retry.py``) around the multi-process KV, and the wire's chunk
digests (``integrity.py``). The fault injector, heartbeats and auto-resume
are not ported yet (ROADMAP.md)."""

from ps_pytorch_tpu_torch.resilience.retry import (  # noqa: F401
    RetryBudget, RetryingKV, RetryPolicy, call_with_retry, is_retryable,
)


def wrap_kv_with(kv, cfg):
    """The JAX package's ``resilience.wrap_kv_with`` without the fault
    plane (not ported yet, ROADMAP.md): ``kv`` behind a
    :class:`RetryingKV` when ``kv_retry_attempts`` is above 1. Returns
    ``(kv, retrier)``, the retrier None when retries are off."""
    retrier = None
    attempts = int(getattr(cfg, "kv_retry_attempts", 1) or 1)
    if attempts > 1:
        policy = RetryPolicy(
            max_attempts=attempts,
            base_s=float(getattr(cfg, "kv_retry_base_s", 0.05)),
            seed=int(getattr(cfg, "seed", 0)))
        budget = int(getattr(cfg, "kv_retry_budget", 0) or 0)
        retrier = RetryingKV(kv, policy,
                             budget=RetryBudget(budget) if budget else None)
        kv = retrier
    return kv, retrier
