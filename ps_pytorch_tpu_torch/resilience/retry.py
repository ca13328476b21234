"""Jittered exponential backoff: the JAX package's
``resilience/retry.py`` (``RetryPolicy`` ``:50-69`` and the classifier
``is_retryable``), the part the Coordinator's mask wait runs. The retry
budget and the KV retry wrapper (``kv_retry_attempts``) are not ported
yet (ROADMAP.md).

Only errors that look transient (connection, timeout, the coordination
service's UNAVAILABLE family) are retried; programming errors surface at
once.
"""

from dataclasses import dataclass

import numpy as np

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
    if isinstance(exc, (ConnectionError, TimeoutError)):
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
