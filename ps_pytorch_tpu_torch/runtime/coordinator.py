"""The Coordinator, the control plane of synchronous training: the JAX
package's ``runtime/coordinator.py`` (``KVStore`` ``:39-76``,
``Coordinator`` ``:238-625``) without its elastic planes.

It keeps step control (the reference's tag 10), the per-step
participation mask (the backup workers' ``--num-aggregate`` cutoff,
``sync_replicas_master_nn.py:179``) and the straggler deadline (tag 77),
on a key-value store that every process shares: an in-process dict for
one process, the process group's ``TCPStore`` across processes
(``DistributedKV``). Process 0 leads: it decides each step's mask from the
replicas' reported step times and publishes it; every other process waits
for the published mask, so all of them consume the same one.

Policies:

- sync: everyone participates every step.
- kofn: only the K replicas with the fastest last reported step time
  contribute, lowest index first among equal times.
- deadline: replicas whose last step took more than ``kill_threshold``
  seconds are masked out.

Keys and values are byte-equal to the JAX package's: ``{run}/step``,
``{run}/dur/{r}`` = ``json.dumps([step, seconds])``, ``{run}/mask/{step}``
= ``json.dumps(mask.tolist())`` and ``{run}/kill/{r}``. With a
``liveness`` monitor (``resilience/heartbeat.py``) the leader folds missed
heartbeats into the mask: a crashed replica is masked out, never everyone.
The leader lease, elections and membership are not ported yet
(ROADMAP.md): their arguments raise. ``FileKV`` waits for the replicated
KV (``runtime/kvrep.py``), its only user.
"""

import json
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from ps_pytorch_tpu_torch.resilience.retry import RetryPolicy, is_retryable
from ps_pytorch_tpu_torch.telemetry.trace import span as _span


class LeaderLost(RuntimeError):
    """The leader's lease went stale while a follower waited on it. Kept
    for the JAX package's interface; the lease is not ported yet, so
    nothing raises it."""


class KVStore:
    """Minimal KV interface: an in-process dict. ``DistributedKV`` holds
    the same keys on the process group's TCPStore."""

    def __init__(self):
        self._d: Dict[str, str] = {}
        self._lock = threading.Lock()

    def set(self, key: str, value: str) -> None:
        with self._lock:
            self._d[key] = value

    def get(self, key: str, default: Optional[str] = None) -> Optional[str]:
        with self._lock:
            return self._d.get(key, default)

    def delete(self, key: str) -> None:
        with self._lock:
            self._d.pop(key, None)

    def keys(self, prefix: str = "") -> List[str]:
        """Keys under ``prefix`` (in-process store only)."""
        with self._lock:
            return sorted(k for k in self._d if k.startswith(prefix))


# Never a value of the KV (its values are ASCII text): the "expected" and
# "desired" value of the compare-and-set that reads a key without waiting.
_ABSENT = b"\x00ps_tpu_absent\x00"


class DistributedKV(KVStore):
    """KV over a ``torch.distributed`` store (the TCPStore of
    ``parallel/dist.py:initialize_from_env``), seen by every process. Keys
    live on the raw store, byte-equal to the JAX package's."""

    def __init__(self, store):
        self._store = store

    def set(self, key: str, value: str) -> None:
        self._store.set(key, value)        # overwrites

    def get(self, key: str, default: Optional[str] = None) -> Optional[str]:
        """The value, or ``default`` at once when the key is absent.
        ``TCPStore.get`` waits up to the store's timeout for a missing key,
        and a check before it races a writer's delete (the wire's GC), so
        the read is one compare-and-set whose expected value no key holds:
        it answers the stored value, or the expected one when the key is
        absent, and never creates or changes the key. Only a missing key
        maps to the default: a dead store raises here."""
        got = self._store.compare_set(key, _ABSENT, _ABSENT)
        return default if got == _ABSENT else got.decode()

    def delete(self, key: str) -> None:
        self._store.delete_key(key)

    def keys(self, prefix: str = "") -> List[str]:
        raise NotImplementedError("the distributed store has no scan")


class Coordinator:
    def __init__(self, n_replicas: int, mode: str = "sync",
                 num_aggregate: int = 0, kill_threshold: float = 0.0,
                 kv: Optional[KVStore] = None, run_id: str = "run",
                 leader: bool = True, mask_gc_window: int = 50,
                 liveness=None, lease_interval_s: float = 0.0,
                 lease_timeout_s: float = 0.0, clock=None,
                 election=None, membership=None, liveness_factory=None):
        if mode not in ("sync", "kofn", "async"):
            raise ValueError(f"unknown mode {mode!r}")
        if mode == "kofn" and not (0 < num_aggregate <= n_replicas):
            raise ValueError(
                f"kofn requires 0 < num_aggregate <= {n_replicas}, got "
                f"{num_aggregate}")
        unported = {"election": election,
                    "membership": membership,
                    "liveness_factory": liveness_factory,
                    "lease_interval_s": lease_interval_s or None,
                    "lease_timeout_s": lease_timeout_s or None,
                    "clock": clock}
        for name, value in unported.items():
            if value is not None:
                raise ValueError(f"Coordinator({name}=...) is not ported yet "
                                 "(ROADMAP.md)")
        self.n = n_replicas
        self.mode = mode
        self.k = num_aggregate
        self.kill_threshold = kill_threshold
        self.kv = kv or KVStore()
        self.run_id = run_id
        self.leader = leader
        self.liveness = liveness
        self.mask_gc_window = max(int(mask_gc_window), 2)
        self.stats: Dict[str, int] = {"mask_changes": 0}
        # Follower mask-wait backoff: from a 2 ms poll exponentially to
        # 100 ms, jittered so followers do not poll in lockstep; seeded by
        # the replica count.
        self._mask_backoff = RetryPolicy(base_s=0.002, max_s=0.1,
                                         jitter=0.5, seed=n_replicas)
        self._mask_rng = self._mask_backoff.delays()
        self._last_printed_mask: Optional[str] = None
        # last observed per-replica step duration (seconds)
        self._last_duration = np.zeros(n_replicas, np.float64)
        self._killed = np.zeros(n_replicas, bool)

    # ---- step control (tag 10 equivalent) ----
    def announce_step(self, step: int) -> None:
        self.kv.set(f"{self.run_id}/step", str(step))

    def current_step(self) -> int:
        return int(self.kv.get(f"{self.run_id}/step", "0"))

    def wait_for_step(self, after: int, timeout_s: float = 300.0,
                      poll_s: float = 0.01) -> int:
        """Spin until the announced step advances past ``after``."""
        deadline = time.monotonic() + timeout_s
        while True:
            cur = self.current_step()
            if cur > after:
                return cur
            if time.monotonic() > deadline:
                raise TimeoutError(f"step did not advance past {after}")
            time.sleep(poll_s)

    # ---- telemetry ----
    def report_duration(self, replica: int, step: int,
                        seconds: float) -> None:
        """Record a replica's last step duration, one clock a process."""
        self._last_duration[replica] = seconds
        self.kv.set(f"{self.run_id}/dur/{replica}",
                    json.dumps([step, seconds]))

    def pull_durations(self) -> np.ndarray:
        for r in range(self.n):
            v = self.kv.get(f"{self.run_id}/dur/{r}")
            if v is not None:
                _, s = json.loads(v)
                self._last_duration[r] = s
        return self._last_duration

    # ---- participation policy (num_aggregate / tag 77 equivalents) ----
    def participation_mask(self, step: int,
                           timeout_s: float = 300.0) -> np.ndarray:
        """float32[n] mask for step ``step``'s masked mean. Every replica
        must consume the SAME mask or the parameters diverge, so the
        leader decides it and publishes it on the KV; followers block on
        the published value. Recorded as the ambient span
        ``coordinator_mask``: on a follower the mask wait, the stall a
        straggling leader puts on everyone; on the leader the decision
        and the publish."""
        key = f"{self.run_id}/mask/{step}"
        with _span("coordinator_mask", step=step):
            if not self.leader:
                return self._await_mask(key, step, timeout_s)
            return self._decide_and_publish_mask(key, step)

    def _await_mask(self, key: str, step: int,
                    timeout_s: float) -> np.ndarray:
        """Follower-side wait: jittered exponential backoff; a transient
        KV error counts as "not published yet", a fatal one raises, and
        the deadline raises TimeoutError."""
        deadline = time.monotonic() + timeout_s
        attempt = 0
        while True:
            try:
                v = self.kv.get(key)
            except Exception as e:
                if not is_retryable(e):
                    raise
                self.stats["mask_wait_errors"] = \
                    self.stats.get("mask_wait_errors", 0) + 1
                v = None
            if v is not None:
                return np.asarray(json.loads(v), np.float32)
            now = time.monotonic()
            if now > deadline:
                raise TimeoutError(f"no mask published for step {step}")
            delay = self._mask_backoff.delay(attempt, self._mask_rng)
            time.sleep(min(delay, max(deadline - now, 0.0)))
            attempt = min(attempt + 1, 30)      # the delay saturates at max_s

    def _decide_and_publish_mask(self, key: str, step: int) -> np.ndarray:
        mask = self._decide_mask()
        # One line whenever the decision changes.
        desc = json.dumps(mask.astype(int).tolist())
        if desc != self._last_printed_mask:
            print(f"MASK step {step} {desc}", flush=True)
            if self._last_printed_mask is not None:
                self.stats["mask_changes"] += 1
            self._last_printed_mask = desc
        self.kv.set(key, json.dumps(mask.tolist()))
        # Keep a wide window of old masks for followers that lag behind.
        if step >= self.mask_gc_window:
            self.kv.delete(
                f"{self.run_id}/mask/{step - self.mask_gc_window}")
        return mask

    def _decide_mask(self) -> np.ndarray:
        # Kills issued on any process reach the leader through the KV.
        self._refresh_kills()
        mask = (~self._killed).astype(np.float32)
        if self.liveness is not None:
            # Missed-heartbeat eviction (dead, not slow); a view where
            # everyone is dead falls through to the fallback below rather
            # than masking everyone out.
            alive = np.asarray(self.liveness.alive_mask(), bool)
            if alive.any():
                mask *= alive.astype(np.float32)
        if self.mode == "sync":
            if mask.sum() == 0:
                mask = (~self._killed).astype(np.float32)
                if mask.sum() == 0:
                    mask = np.ones(self.n, np.float32)
            return mask
        dur = self.pull_durations()
        if self.kill_threshold > 0:
            mask *= (dur <= self.kill_threshold).astype(np.float32)
        if self.mode == "kofn" and self.k < self.n:
            # Fastest K by last reported duration ("the first K gradient
            # arrivals"); the stable sort keeps the lower index among
            # equal durations.
            alive = np.nonzero(mask > 0)[0]
            if len(alive) > self.k:
                keep = alive[np.argsort(dur[alive], kind="stable")[:self.k]]
                mask = np.zeros(self.n, np.float32)
                mask[keep] = 1.0
        if mask.sum() == 0:
            # Never wedge: fall back to everyone not killed, else everyone.
            mask = (~self._killed).astype(np.float32)
            if mask.sum() == 0:
                mask = np.ones(self.n, np.float32)
        return mask

    # ---- kill protocol (tag 77 equivalent) ----
    def kill(self, replica: int) -> None:
        self._killed[replica] = True
        self.kv.set(f"{self.run_id}/kill/{replica}", "1")

    def is_killed(self, replica: int) -> bool:
        return self.kv.get(f"{self.run_id}/kill/{replica}") == "1"

    def _refresh_kills(self) -> None:
        """Fold the KV's kill keys into the local set. Kills are
        permanent, so only 0 -> 1 transitions are read."""
        for r in range(self.n):
            if not self._killed[r] and \
                    self.kv.get(f"{self.run_id}/kill/{r}") == "1":
                self._killed[r] = True
