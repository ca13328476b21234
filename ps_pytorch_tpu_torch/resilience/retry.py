"""Jittered exponential backoff with a retry budget: the JAX package's
``resilience/retry.py`` (``RetryPolicy``, ``RetryBudget``,
``call_with_retry``, ``RetryingKV`` and the classifier ``is_retryable``).

Without this layer one store hiccup anywhere in the control plane (a mask
publish, a duration report, a gradient chunk on the wire) kills a run. KV
operations go through :func:`call_with_retry`, which tells retryable from
fatal errors, backs off exponentially with deterministic jitter, and
charges a run-wide budget, so that a store that is down for good still
fails fast. Only errors that look transient (connection, timeout, the
coordination service's UNAVAILABLE family) are retried; programming errors
surface at once, and the fault plane's ``TransientKVError`` is always
retried.
"""

import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np

from ps_pytorch_tpu_torch.resilience.faults import TransientKVError

# Textual markers of transient store failures. NOT_FOUND is absent on
# purpose: a missing key is an answer (the get() default), not an outage.
_TRANSIENT_MARKERS = (
    "unavailable", "deadline_exceeded", "deadline exceeded", "aborted",
    "resource_exhausted", "connection reset", "connection refused",
    "broken pipe", "temporarily", "timed out", "timeout", "eof",
)


def is_retryable(exc: BaseException) -> bool:
    """True for errors worth retrying (transient service or transport),
    False for errors that retrying cannot fix."""
    if isinstance(exc, (TransientKVError, ConnectionError, TimeoutError)):
        return True
    if isinstance(exc, (ValueError, TypeError, KeyError, AttributeError,
                        ArithmeticError)):
        return False
    msg = str(exc).lower()
    return any(m in msg for m in _TRANSIENT_MARKERS)


@dataclass(frozen=True)
class RetryPolicy:
    """max_attempts includes the first try; delay_k = min(max_s,
    base_s * multiplier**k) * (1 - jitter * u_k) with u_k ~ U[0,1) from a
    seeded stream: deterministic given the seed, de-synchronized across
    processes when seeds differ."""
    max_attempts: int = 5
    base_s: float = 0.05
    max_s: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.5
    seed: int = 0

    def delays(self) -> "np.random.Generator":
        return np.random.default_rng(self.seed)

    def delay(self, attempt: int, rng) -> float:
        d = min(self.max_s, self.base_s * self.multiplier ** attempt)
        if self.jitter > 0:
            d *= 1.0 - self.jitter * float(rng.random())
        return d


class RetryBudget:
    """Run-wide cap on total retries across every operation that shares
    it. An exhausted budget fails fast: the next retryable error is
    re-raised without sleeping."""

    def __init__(self, limit: int):
        self.limit = int(limit)
        self.spent = 0

    def take(self) -> bool:
        if self.spent >= self.limit:
            return False
        self.spent += 1
        return True


def call_with_retry(fn: Callable, *args,
                    policy: Optional[RetryPolicy] = None,
                    budget: Optional[RetryBudget] = None,
                    classify: Callable[[BaseException], bool] = is_retryable,
                    sleep: Optional[Callable[[float], None]] = None,
                    rng=None,
                    on_retry: Optional[Callable[[int, BaseException], None]]
                    = None, **kwargs):
    """Run ``fn(*args, **kwargs)``, retrying retryable errors under
    ``policy``. Raises the last error after max_attempts, and at once on a
    fatal error or an exhausted budget."""
    policy = policy or RetryPolicy()
    sleep = sleep or time.sleep
    rng = rng if rng is not None else policy.delays()
    for attempt in range(policy.max_attempts):
        try:
            return fn(*args, **kwargs)
        except Exception as e:
            if not classify(e):
                raise
            if attempt + 1 >= policy.max_attempts:
                raise
            if budget is not None and not budget.take():
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            sleep(policy.delay(attempt, rng))
    raise AssertionError("unreachable")


class RetryingKV:
    """KV-shaped shim that retries the inner store's transient failures.

    ``kv_retries`` counts re-attempts and ``kv_giveups`` operations that
    ran out of attempts or budget and re-raised, so that a noisy but
    surviving store shows in the metrics."""

    def __init__(self, inner, policy: Optional[RetryPolicy] = None,
                 budget: Optional[RetryBudget] = None,
                 sleep: Optional[Callable[[float], None]] = None):
        self.inner = inner
        self.policy = policy or RetryPolicy()
        self.budget = budget
        self._sleep = sleep or time.sleep
        self._rng = self.policy.delays()
        self.counters: Dict[str, int] = {"kv_retries": 0, "kv_giveups": 0}

    def _call(self, fn, *args, **kwargs):
        def count(_attempt, _exc):
            self.counters["kv_retries"] += 1
        try:
            return call_with_retry(
                fn, *args, policy=self.policy, budget=self.budget,
                sleep=self._sleep, rng=self._rng, on_retry=count, **kwargs)
        except Exception as e:
            if is_retryable(e):
                self.counters["kv_giveups"] += 1
            raise

    def set(self, key: str, value: str) -> None:
        self._call(self.inner.set, key, value)

    def get(self, key: str, default: Optional[str] = None) -> Optional[str]:
        return self._call(self.inner.get, key, default)

    def delete(self, key: str) -> None:
        self._call(self.inner.delete, key)

    def keys(self, prefix: str = ""):
        return self._call(self.inner.keys, prefix)

    def snapshot(self) -> Dict[str, int]:
        return dict(self.counters)
