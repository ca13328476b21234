"""The Coordinator, the control plane of synchronous training: the JAX
package's ``runtime/coordinator.py`` (``KVStore`` ``:39-76``, ``FileKV``
``:151-236``, ``Coordinator`` ``:238-625``).

It keeps step control (the reference's tag 10), the per-step
participation mask (the backup workers' ``--num-aggregate`` cutoff,
``sync_replicas_master_nn.py:179``) and the straggler deadline (tag 77),
on a key-value store that every process shares: an in-process dict for
one process, the process group's ``TCPStore`` across processes
(``DistributedKV``), a directory (``FileKV``), or several of them under
quorum replication (``runtime/kvrep.py:ReplicatedKV``). The leader (process
0 unless an election says otherwise) decides each step's mask from the
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
= ``json.dumps(mask.tolist())``, ``{run}/kill/{r}`` and the lease
``{run}/lease`` = ``json.dumps([step, ts])``. With a ``liveness`` monitor
(``resilience/heartbeat.py``) the leader folds missed heartbeats into the
mask: a crashed replica is masked out, never everyone.

The leader lease (``lease_interval_s``): the leader refreshes one key as
it publishes masks, and a follower whose mask wait finds the lease stale
raises ``LeaderLost`` instead of waiting out its deadline. With an
``election`` (``elastic/election.py``) the lease is the election's
epoch-numbered one, ``LeaderLost`` is answered inside the mask wait by a
campaign (the winner prints ``ELECTED``, the others ``FOLLOW``), and a
leader whose refresh finds a higher epoch demotes itself (``DEPOSED``).
With a ``membership`` registry (``elastic/membership.py``) the leader
folds admissions and evictions into the mask at each step boundary.
"""

import json
import os
import tempfile
import threading
import time
from typing import Dict, List, Optional
from urllib.parse import quote, unquote

import numpy as np

from ps_pytorch_tpu_torch.resilience.retry import RetryPolicy, is_retryable
from ps_pytorch_tpu_torch.telemetry.trace import span as _span


class LeaderLost(RuntimeError):
    """The leader's lease went stale while a follower waited on it.

    Raised from the follower's mask wait, so a dead leader surfaces at
    once instead of as a TimeoutError at the deadline. With an election
    wired it is caught INSIDE ``participation_mask`` and answered by a
    campaign; it escapes only when elections are off or the campaign
    itself fails (a partition), where auto-resume is the escalation."""


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


# The TCPStore's server (c10d's libuv backend) drops a message above
# 8 MiB, and one --shard-wire shard of ResNet-18 is ~19 MB of base85: a
# larger value is stored as parts of at most this many characters under
# side keys, with a small header at the key itself.
PART_CHARS = 4 << 20
_PARTS = "\x00ps_tpu_parts:"


class DistributedKV(KVStore):
    """KV over a ``torch.distributed`` store (the TCPStore of
    ``parallel/dist.py:initialize_from_env``), seen by every process. Keys
    live on the raw store, byte-equal to the JAX package's.

    A value longer than ``PART_CHARS`` goes in parts: each under
    ``<key>\\x00<nonce>/<i>``, written first, then the header
    ``\\x00ps_tpu_parts:<nonce>/<n>`` at the key (no base85 or JSON value
    starts with a NUL). The logical key and value are what the caller
    gave; a reader that finds a part gone (overwritten or deleted under
    it) reads the key as absent, as it would a value deleted a moment
    earlier. The writer deletes the parts it wrote when it overwrites or
    deletes the key."""

    def __init__(self, store):
        self._store = store
        self._parts: Dict[str, List[str]] = {}   # key -> part keys written
        self._lock = threading.Lock()

    def set(self, key: str, value: str) -> None:
        parts = []
        if len(value) > PART_CHARS:
            nonce = os.urandom(6).hex()
            for i in range(0, len(value), PART_CHARS):
                part = f"{key}\x00{nonce}/{i // PART_CHARS}"
                self._store.set(part, value[i:i + PART_CHARS])
                parts.append(part)
            value = f"{_PARTS}{nonce}/{len(parts)}"
        self._store.set(key, value)        # overwrites
        with self._lock:
            old = self._parts.pop(key, [])
            if parts:
                self._parts[key] = parts
        for part in old:
            self._store.delete_key(part)

    def _read(self, key: str) -> Optional[str]:
        got = self._store.compare_set(key, _ABSENT, _ABSENT)
        return None if got == _ABSENT else got.decode()

    def get(self, key: str, default: Optional[str] = None) -> Optional[str]:
        """The value, or ``default`` at once when the key is absent.
        ``TCPStore.get`` waits up to the store's timeout for a missing key,
        and a check before it races a writer's delete (the wire's GC), so
        the read is one compare-and-set whose expected value no key holds:
        it answers the stored value, or the expected one when the key is
        absent, and never creates or changes the key. Only a missing key
        maps to the default: a dead store raises here."""
        got = self._read(key)
        if got is None:
            return default
        if not got.startswith(_PARTS):
            return got
        nonce, n = got[len(_PARTS):].rsplit("/", 1)
        out = []
        for i in range(int(n)):
            part = self._read(f"{key}\x00{nonce}/{i}")
            if part is None:
                return default
            out.append(part)
        return "".join(out)

    def delete(self, key: str) -> None:
        self._store.delete_key(key)
        with self._lock:
            old = self._parts.pop(key, [])
        for part in old:
            self._store.delete_key(part)

    def keys(self, prefix: str = "") -> List[str]:
        raise NotImplementedError("the distributed store has no scan")


class FileKV(KVStore):
    """KV over a shared directory, one file a key (the name is the key,
    percent-quoted). A write goes through a temporary file and
    ``os.replace``, so a reader never sees a torn value; the data is
    fsynced before the rename and the directory after it, so a power cut
    cannot commit a rename whose bytes are still in the page cache; a
    write that fails leaves no temporary file behind. ``keys()`` lists
    the directory."""

    def __init__(self, root: str):
        super().__init__()
        self._root = root
        os.makedirs(root, exist_ok=True)

    @staticmethod
    def _fname(key: str) -> str:
        return quote(key, safe="")

    def set(self, key: str, value: str) -> None:
        path = os.path.join(self._root, self._fname(key))
        fd, tmp = tempfile.mkstemp(dir=self._root, prefix=".tmp-")
        try:
            with os.fdopen(fd, "w") as f:
                f.write(value)
                f.flush()
                os.fsync(fd)
            os.replace(tmp, path)
            dfd = os.open(self._root,
                          os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def get(self, key: str, default: Optional[str] = None) -> Optional[str]:
        try:
            with open(os.path.join(self._root, self._fname(key))) as f:
                return f.read()
        except OSError:
            return default

    def delete(self, key: str) -> None:
        try:
            os.unlink(os.path.join(self._root, self._fname(key)))
        except OSError:
            pass

    def keys(self, prefix: str = "") -> List[str]:
        try:
            names = os.listdir(self._root)
        except OSError:
            return []
        out = []
        for n in names:
            if n.startswith(".tmp-"):
                continue
            k = unquote(n)
            if k.startswith(prefix):
                out.append(k)
        return sorted(out)


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
        self.n = n_replicas
        self.mode = mode
        self.k = num_aggregate
        self.kill_threshold = kill_threshold
        self.kv = kv or KVStore()
        self.run_id = run_id
        self.leader = leader
        self.mask_gc_window = max(int(mask_gc_window), 2)
        # Leader-side LivenessMonitor: folds missed heartbeats into the
        # mask (a crashed host stops reporting durations altogether).
        self.liveness = liveness
        # The leader lease (--leader-lease-s): refreshed by the leader as
        # it publishes masks; a follower that finds it stale raises
        # LeaderLost from the mask wait. 0 = off. Both ends share a clock
        # domain: wall time, or one ManualClock in tests.
        self.lease_interval_s = float(lease_interval_s)
        self.lease_timeout_s = float(lease_timeout_s) or \
            3.0 * self.lease_interval_s
        self.clock = clock or time.time
        self._lease_last = float("-inf")
        # The elastic planes: with an election, LeaderLost is answered by
        # a campaign and this Coordinator can promote itself to leader
        # (or demote on Deposed) mid-run; membership is the leader's
        # epoch'd registry, folded into the mask at step boundaries;
        # liveness_factory builds a LivenessMonitor when a follower is
        # promoted (followers are built without one).
        self.election = election
        self.membership = membership
        self._liveness_factory = liveness_factory
        self.events: list = []
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
            if self.election is None:
                if not self.leader:
                    return self._await_mask(key, step, timeout_s)
                return self._decide_and_publish_mask(key, step)
            # Elastic: leadership can change hands inside one mask wait. A
            # deposed leader demotes and waits as a follower; a follower
            # whose wait raises LeaderLost campaigns, and either promotes
            # (then decides this very mask) or follows the winner.
            from ps_pytorch_tpu_torch.elastic.election import Deposed
            while True:
                if self.leader:
                    try:
                        return self._decide_and_publish_mask(key, step)
                    except Deposed:
                        self._demote(step)
                        continue
                try:
                    return self._await_mask(key, step, timeout_s)
                except LeaderLost:
                    self._failover(step)

    # ---- elastic failover (election wired; elastic/election.py) ----
    def _failover(self, step: int) -> None:
        """A follower's mask wait saw a stale lease: campaign. Winning
        makes this Coordinator the mask authority of the new epoch;
        losing means a peer claimed a fresh lease, and the wait resumes
        against it. ElectionFailed (no leader after the bounded rounds)
        propagates: that is a partition, and auto-resume the escalation."""
        self.stats["elections"] = self.stats.get("elections", 0) + 1
        won = self.election.campaign()
        self.stats["leader_epoch"] = self.election.epoch
        if won:
            self.leader = True
            self._lease_last = float("-inf")
            self._last_printed_mask = None      # log the takeover mask
            if self.liveness is None and self._liveness_factory is not None:
                self.liveness = self._liveness_factory()
            print(f"ELECTED leader epoch {self.election.epoch} "
                  f"at step {step}", flush=True)
            self.events.append({"event": "elected",
                                "epoch": self.election.epoch,
                                "step": int(step),
                                "t": round(self.clock(), 3)})
        else:
            print(f"FOLLOW leader {self.election.owner} "
                  f"epoch {self.election.epoch} at step {step}", flush=True)
            self.events.append({"event": "follow",
                                "epoch": self.election.epoch,
                                "owner": self.election.owner,
                                "step": int(step),
                                "t": round(self.clock(), 3)})

    def _demote(self, step: int) -> None:
        """Epoch fencing fired mid-publish: a higher epoch owns the lease,
        so this process's mask authority is gone. Its in-flight mask write
        may have landed, but the new leader publishes the same key again:
        last writer wins, the new epoch's decision."""
        self.leader = False
        self.stats["deposed"] = self.stats.get("deposed", 0) + 1
        self.stats["leader_epoch"] = self.election.epoch
        print(f"DEPOSED at step {step}: following leader "
              f"{self.election.owner} epoch {self.election.epoch}",
              flush=True)
        self.events.append({"event": "deposed",
                            "epoch": self.election.epoch,
                            "owner": self.election.owner,
                            "step": int(step),
                            "t": round(self.clock(), 3)})

    def _await_mask(self, key: str, step: int,
                    timeout_s: float) -> np.ndarray:
        """Follower-side wait: jittered exponential backoff; a transient
        KV error counts as "not published yet", a fatal one raises, and
        the deadline raises TimeoutError. With a lease, a stale one ends
        the wait as LeaderLost: the leader is dead, not slow."""
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
            self._check_lease(step)
            now = time.monotonic()
            if now > deadline:
                raise TimeoutError(f"no mask published for step {step}")
            delay = self._mask_backoff.delay(attempt, self._mask_rng)
            time.sleep(min(delay, max(deadline - now, 0.0)))
            attempt = min(attempt + 1, 30)      # the delay saturates at max_s

    # ---- the leader lease (death detection) ----
    def _refresh_lease(self, step: int) -> None:
        """Leader-side: refresh the lease, throttled to its interval. With
        an election, the election's epoch-fenced refresh, which checks
        ownership unthrottled and raises Deposed when a higher epoch
        claimed (``participation_mask`` demotes); the ``[step, ts]`` key is
        then not written."""
        if self.election is not None:
            self.election.refresh(step)
            return
        if self.lease_interval_s <= 0 or not self.leader:
            return
        now = self.clock()
        if now - self._lease_last < self.lease_interval_s:
            return
        self._lease_last = now
        self.kv.set(f"{self.run_id}/lease", json.dumps([step, now]))

    def _check_lease(self, step: int) -> None:
        """Follower-side: raise LeaderLost when the lease exists and went
        stale. A lease never written is bootstrap grace (the leader may
        not have reached its first publish); transient KV errors are
        absorbed like the mask read's."""
        if self.leader:
            return
        if self.election is not None:
            try:
                status = self.election.check()
            except Exception as e:
                if not is_retryable(e):
                    raise
                self.stats["mask_wait_errors"] = \
                    self.stats.get("mask_wait_errors", 0) + 1
                return
            if status == "stale":
                self.stats["leader_lost"] = \
                    self.stats.get("leader_lost", 0) + 1
                raise LeaderLost(
                    f"leader epoch {self.election.epoch} lease stale "
                    f"(> {self.election.timeout_s}s) waiting for step "
                    f"{step}'s mask")
            return
        if self.lease_interval_s <= 0:
            return
        try:
            v = self.kv.get(f"{self.run_id}/lease")
        except Exception as e:
            if not is_retryable(e):
                raise
            self.stats["mask_wait_errors"] = \
                self.stats.get("mask_wait_errors", 0) + 1
            return
        if v is None:
            return
        lease_step, ts = json.loads(v)
        age = self.clock() - ts
        if age > self.lease_timeout_s:
            self.stats["leader_lost"] = self.stats.get("leader_lost", 0) + 1
            raise LeaderLost(
                f"leader lease stale by {age:.2f}s (> {self.lease_timeout_s}"
                f"s) waiting for step {step}'s mask; last refresh at its "
                f"step {lease_step}")

    def _decide_and_publish_mask(self, key: str, step: int) -> np.ndarray:
        self._refresh_lease(step)
        if self.membership is not None:
            # Admissions and evictions fold into the epoch'd view at the
            # step boundary ({run}/member/view is published on a change).
            self.membership.update(step)
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
        if self.membership is not None:
            # The registry's all-ones view (nobody announced yet) keeps
            # the static world; the fallbacks below apply to membership
            # as to liveness.
            mview = np.asarray(self.membership.mask(), np.float32)[:self.n]
            if mview.any():
                mask *= mview
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
