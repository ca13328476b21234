"""Deterministic fault injection: the JAX package's
``resilience/faults.py``.

Every failure mode the synchronous trainer claims to survive can be
injected from a seeded spec (``--fault-spec``), so the chaos tests are
deterministic and the same drills run from the CLI.

Spec grammar (``;``-separated faults, each ``kind:key=val,key=val``),
copied whole, so a spec the JAX config accepts or rejects is accepted or
rejected here with the same message:

    kv_drop:p=0.05,seed=7[,op=set|get|delete]
        Each matching KV op raises a transient ``UNAVAILABLE`` error with
        probability ``p``, before any state changes. The retry plane
        (retry.py) turns these into survived hiccups.
    kv_delay:p=0.1,s=0.02,seed=3[,op=...]
        Matching ops sleep ``s`` seconds with probability ``p``.
    replica_crash:r=0,step=40
        Process ``r`` raises :class:`InjectedCrash` at the top of step
        ``step``, once per injector lifetime: an auto-resumed run (which
        shares the injector) does not crash again.
    ckpt_corrupt:step=20[,mode=truncate|flip]
        The committed checkpoint of ``step`` is corrupted right after its
        atomic rename, once: the torn or bit-rotted artifact the manifest
        check must catch.
    grad_nan:step=30[,r=0]
        Process ``r``'s participation mask is poisoned with NaN at step
        ``step`` (once); the NaN rides the step's reductions into the
        loss, the gradient and its norm, where the watchdogs must catch it.
    kv_partition:r=1,step=5,steps=4 | kv_partition:group=1,gsize=2,...
        Every KV op of the named processes (or sync group) raises the
        transient error for the step window [step, step+steps).
    link_jitter:s=0.02[,prefix=...][,p=0.5,seed=3][,op=...]
        Matching ops on keys under ``prefix`` sleep ``s`` seconds.
    payload_bitflip:p=0.05,seed=9[,prefix=...]
    payload_truncate:p=0.02,seed=4[,prefix=...]
        Reader-side corruption of a returned payload chunk (a key whose
        last two path components are numeric).
    leader_kill:step=6
        The process that holds leadership at a step >= ``step`` prints the
        ``FAULT leader_kill`` line and SIGKILLs itself (once): no finally
        blocks, no last beat; the election must recover.
    kv_backend_kill:backend=1,step=5[,steps=0]
        Every op routed to backend ``backend`` of a ``ReplicatedKV``
        (``runtime/kvrep.py``) raises the transient error for the step
        window [step, step+steps) (steps=0: to the end of the run): below
        the quorum layer, so the replication, not the retry budget, must
        absorb it.
    kv_backend_wipe:backend=1,step=8
        Backend ``backend`` loses its whole keyspace at step ``step``
        (once) and keeps serving, empty; anti-entropy resync repairs it.
    grad_poison:scale=1000,r=2[,step=0][,steps=0]
        Process ``r``'s OWN gradients are multiplied by ``scale`` before
        encode for every step in [step, step+steps) (steps=0: to the end
        of the run): the corruption rides the real wire, and the leader's
        integrity screen must catch it (``resilience/integrity.py``).
    replica_kill:served=20[,r=0]
        SIGKILL serving replica r once it has served >= N requests
        (``maybe_kill_replica``, beaten by ``serving/engine.serve_loop``);
        the trainers pass it by.

Drop and delay decisions come from ``numpy.default_rng(seed + 10007 *
pid)``, the JAX package's stream: reproducible per process, uncorrelated
across processes.
"""

import os
from typing import Any, Callable, Dict, List, Optional

import numpy as np

_KINDS = ("kv_drop", "kv_delay", "replica_crash", "ckpt_corrupt", "grad_nan",
          "leader_kill", "kv_partition", "link_jitter", "replica_kill",
          "payload_bitflip", "payload_truncate", "grad_poison",
          "kv_backend_kill", "kv_backend_wipe")
_KV_OPS = ("set", "get", "delete")
# The kinds FaultyKV enforces (everything else fires from the step /
# checkpoint / serving planes).
_KV_FAULT_KINDS = ("kv_drop", "kv_delay", "kv_partition", "link_jitter",
                   "payload_bitflip", "payload_truncate")
# The kinds BackendFaultyKV enforces, scoped to ONE replica of a
# ReplicatedKV, injected INSIDE the quorum layer via ``wrap_backend``.
_BACKEND_FAULT_KINDS = ("kv_backend_kill", "kv_backend_wipe")
# base64's b85 alphabet (spelled out; resilience/ stays a leaf): bitflips
# substitute IN-alphabet so the armour still decodes and only the wire
# digest can tell.
_B85_CHARS = ("0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ"
              "abcdefghijklmnopqrstuvwxyz!#$%&()*+-;<=>?@^_`{|}~")


# How a leader_kill fault's line starts; the launcher reads a log that
# ends with it as a death that was asked for.
LEADER_KILL_LINE = "FAULT leader_kill:"


def _is_chunk_key(key: str) -> bool:
    """Payload chunk keys — and only they — end in two numeric path
    components (``<prefix>/<version>/<leaf>/<chunk>``, transport.py wire
    discipline). Meta/pointer/heartbeat keys never match."""
    parts = key.rsplit("/", 2)
    return (len(parts) == 3 and parts[1].isdigit() and parts[2].isdigit())


class TransientKVError(ConnectionError):
    """Injected coordination-service hiccup; always classified retryable
    (retry.is_retryable) — the message carries UNAVAILABLE on purpose so
    the textual classifier treats real and injected faults identically."""


class InjectedCrash(RuntimeError):
    """A replica_crash fault firing — the auto-resume loop's signal to
    rebuild the trainer from the latest valid checkpoint."""


class ManualClock:
    """Fake monotonic clock + sleep for deterministic, real-time-free
    tests: ``sleep`` just advances ``now`` and records the request."""

    def __init__(self, start: float = 0.0):
        self.now = float(start)
        self.sleeps: List[float] = []

    def time(self) -> float:
        return self.now

    def sleep(self, seconds: float) -> None:
        self.sleeps.append(float(seconds))
        self.now += float(seconds)

    def advance(self, seconds: float) -> None:
        self.now += float(seconds)


def _parse_value(s: str) -> Any:
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        return s


def parse_fault_spec(spec: str) -> List[Dict[str, Any]]:
    """``"kind:k=v,...;kind:..."`` -> list of {"kind": ..., params}.
    Raises ValueError on unknown kinds/params — config-time, not
    mid-chaos."""
    faults = []
    for part in (spec or "").split(";"):
        part = part.strip()
        if not part:
            continue
        kind, _, rest = part.partition(":")
        kind = kind.strip()
        if kind not in _KINDS:
            raise ValueError(f"unknown fault kind {kind!r} "
                             f"(one of {', '.join(_KINDS)})")
        params: Dict[str, Any] = {"kind": kind}
        for kv in rest.split(","):
            kv = kv.strip()
            if not kv:
                continue
            k, sep, v = kv.partition("=")
            if not sep:
                raise ValueError(f"fault param {kv!r} is not key=value "
                                 f"(in {part!r})")
            params[k.strip()] = _parse_value(v.strip())
        _validate(params, part)
        faults.append(params)
    return faults


def _validate(p: Dict[str, Any], part: str) -> None:
    kind = p["kind"]
    if kind in ("kv_drop", "kv_delay"):
        prob = p.get("p")
        if not isinstance(prob, (int, float)) or not 0 <= prob <= 1:
            raise ValueError(f"{kind} needs p in [0,1] (got {part!r})")
        if "op" in p and p["op"] not in _KV_OPS:
            raise ValueError(f"{kind} op must be one of {_KV_OPS} "
                             f"(got {part!r})")
        if kind == "kv_delay" and not isinstance(p.get("s"), (int, float)):
            raise ValueError(f"kv_delay needs s=<seconds> (got {part!r})")
    elif kind == "replica_crash":
        if not isinstance(p.get("step"), int):
            raise ValueError(f"replica_crash needs step=<int> (got {part!r})")
        p.setdefault("r", 0)
    elif kind == "ckpt_corrupt":
        if not isinstance(p.get("step"), int):
            raise ValueError(f"ckpt_corrupt needs step=<int> (got {part!r})")
        if p.setdefault("mode", "flip") not in ("flip", "truncate"):
            raise ValueError(f"ckpt_corrupt mode must be flip|truncate "
                             f"(got {part!r})")
    elif kind == "grad_nan":
        if not isinstance(p.get("step"), int):
            raise ValueError(f"grad_nan needs step=<int> (got {part!r})")
        p.setdefault("r", 0)
    elif kind == "leader_kill":
        if not isinstance(p.get("step"), int):
            raise ValueError(f"leader_kill needs step=<int> (got {part!r})")
    elif kind == "replica_kill":
        if not isinstance(p.get("served"), int):
            raise ValueError(f"replica_kill needs served=<int> "
                             f"(got {part!r})")
        p.setdefault("r", 0)
    elif kind == "kv_partition":
        if not isinstance(p.get("step"), int):
            raise ValueError(f"kv_partition needs step=<int> (got {part!r})")
        if not isinstance(p.setdefault("steps", 1), int) or p["steps"] < 1:
            raise ValueError(f"kv_partition needs steps=<int >= 1> "
                             f"(got {part!r})")
        if "group" in p:
            # Subtree scope: membership is derived per process as
            # process_index // gsize == group, so one spec string arms
            # everywhere and self-scopes to the partitioned sync group.
            if not isinstance(p["group"], int) or p["group"] < 0:
                raise ValueError(f"kv_partition group must be an int >= 0 "
                                 f"(got {part!r})")
            if not isinstance(p.setdefault("gsize", 2), int) or \
                    p["gsize"] < 1:
                raise ValueError(f"kv_partition gsize must be an int >= 1 "
                                 f"(got {part!r})")
            if "r" in p:
                raise ValueError(f"kv_partition takes r= or group=, not "
                                 f"both (got {part!r})")
            return
        # r: one process (int) or a '+'-separated subset ("1+2"); parsed
        # into a list here so the window check is a plain membership test.
        r = p.setdefault("r", 0)
        if isinstance(r, int):
            p["r"] = [r]
        elif isinstance(r, str):
            try:
                p["r"] = [int(x) for x in r.split("+")]
            except ValueError:
                raise ValueError(f"kv_partition r must be an int or "
                                 f"'+'-separated ints (got {part!r})")
        else:
            raise ValueError(f"kv_partition r must be an int or "
                             f"'+'-separated ints (got {part!r})")
    elif kind in ("payload_bitflip", "payload_truncate"):
        prob = p.get("p")
        if not isinstance(prob, (int, float)) or not 0 <= prob <= 1:
            raise ValueError(f"{kind} needs p in [0,1] (got {part!r})")
        if "prefix" in p and not isinstance(p["prefix"], str):
            raise ValueError(f"{kind} prefix must be a string "
                             f"(got {part!r})")
    elif kind == "grad_poison":
        if not isinstance(p.get("scale"), (int, float)) or p["scale"] == 0:
            raise ValueError(f"grad_poison needs scale=<nonzero number> "
                             f"(got {part!r})")
        p.setdefault("r", 0)
        if not isinstance(p.setdefault("step", 0), int) or p["step"] < 0:
            raise ValueError(f"grad_poison step must be an int >= 0 "
                             f"(got {part!r})")
        if not isinstance(p.setdefault("steps", 0), int) or p["steps"] < 0:
            raise ValueError(f"grad_poison steps must be an int >= 0 "
                             f"(0 = to end of run) (got {part!r})")
    elif kind in _BACKEND_FAULT_KINDS:
        if not isinstance(p.get("backend"), int) or p["backend"] < 0:
            raise ValueError(f"{kind} needs backend=<int >= 0> "
                             f"(got {part!r})")
        if not isinstance(p.get("step"), int) or p["step"] < 0:
            raise ValueError(f"{kind} needs step=<int >= 0> (got {part!r})")
        if kind == "kv_backend_kill":
            if not isinstance(p.setdefault("steps", 0), int) or \
                    p["steps"] < 0:
                raise ValueError(f"kv_backend_kill steps must be an int >= 0 "
                                 f"(0 = to end of run) (got {part!r})")
    elif kind == "link_jitter":
        s = p.get("s")
        if not isinstance(s, (int, float)) or s <= 0:
            raise ValueError(f"link_jitter needs s=<seconds > 0> "
                             f"(got {part!r})")
        if "p" in p and (not isinstance(p["p"], (int, float))
                         or not 0 <= p["p"] <= 1):
            raise ValueError(f"link_jitter p must be in [0,1] (got {part!r})")
        if "prefix" in p and not isinstance(p["prefix"], str):
            raise ValueError(f"link_jitter prefix must be a string "
                             f"(got {part!r})")
        if "op" in p and p["op"] not in _KV_OPS:
            raise ValueError(f"link_jitter op must be one of {_KV_OPS} "
                             f"(got {part!r})")


class FaultyKV:
    """KVStore-shaped shim injecting drops/delays ahead of the real store.

    Duck-typed on purpose (set/get/delete), so it wraps the in-process
    dict KV, DistributedKV, or another shim identically.
    """

    def __init__(self, inner, faults: List[Dict[str, Any]],
                 injector: "FaultInjector", sleep: Callable[[float], None]):
        self.inner = inner
        self._faults = faults
        self._inj = injector
        self._sleep = sleep
        # One stream per fault entry: drop and delay patterns are
        # independent and each reproducible from its own seed.
        self._rngs = [np.random.default_rng(
            int(f.get("seed", 0)) + 10007 * injector.process_index)
            for f in faults]

    def _partitioned(self, f: Dict[str, Any]) -> bool:
        """Is this process inside the fault's partition scope? ``r=`` names
        raw ranks; ``group=`` names a contiguous sync group of ``gsize``."""
        if "group" in f:
            return self._inj.process_index // f["gsize"] == f["group"]
        return self._inj.process_index in f["r"]

    def _roll(self, op: str, key: str = "") -> None:
        for f, rng in zip(self._faults, self._rngs):
            if f["kind"] == "kv_partition":
                # Total, deterministic, step-windowed: no dice roll. The
                # injector's current_step advances at each step top
                # (maybe_crash), so the window opens/closes with the loop.
                if self._partitioned(f) and \
                        f["step"] <= self._inj.current_step < \
                        f["step"] + f["steps"]:
                    self._inj.counters["kv_partition_drops"] += 1
                    raise TransientKVError(
                        f"UNAVAILABLE: injected kv_partition on {op} "
                        f"(step {self._inj.current_step})")
                continue
            if f["kind"] in ("payload_bitflip", "payload_truncate"):
                continue                # applied to get RESULTS, not ops
            if f.get("op") is not None and f["op"] != op:
                continue
            if f["kind"] == "link_jitter":
                # Key-prefix-scoped delay: models ONE slow link in the
                # hierarchy's key-namespaced topology. No prefix = every
                # link; no p = deterministic (fires on every match).
                if f.get("prefix") and not key.startswith(f["prefix"]):
                    continue
                if "p" in f and rng.random() >= f["p"]:
                    continue
                self._inj.counters["link_jitters"] += 1
                self._sleep(float(f["s"]))
                continue
            if rng.random() >= f["p"]:
                continue
            if f["kind"] == "kv_drop":
                self._inj.counters["kv_drops"] += 1
                raise TransientKVError(
                    f"UNAVAILABLE: injected kv_drop on {op}")
            self._inj.counters["kv_delays"] += 1
            self._sleep(float(f["s"]))

    def set(self, key: str, value: str) -> None:
        self._roll("set", key)
        self.inner.set(key, value)

    def get(self, key: str, default: Optional[str] = None) -> Optional[str]:
        self._roll("get", key)
        return self._maybe_corrupt(key, self.inner.get(key, default))

    def _maybe_corrupt(self, key: str, val):
        """Reader-side payload corruption (payload_bitflip /
        payload_truncate): mutates the RETURNED chunk text, never the
        store — exactly what a flaky NIC or torn read does. Only
        chunk-shaped keys are eligible, so pointers/meta/heartbeats stay
        honest and the blast radius is precisely the integrity layer's
        jurisdiction."""
        if not isinstance(val, str) or not val or not _is_chunk_key(key):
            return val
        for f, rng in zip(self._faults, self._rngs):
            kind = f["kind"]
            if kind not in ("payload_bitflip", "payload_truncate"):
                continue
            if f.get("prefix") and not key.startswith(f["prefix"]):
                continue
            if rng.random() >= f["p"]:
                continue
            if kind == "payload_bitflip":
                pos = int(rng.integers(len(val)))
                repl = old = val[pos]
                while repl == old:
                    repl = _B85_CHARS[int(rng.integers(len(_B85_CHARS)))]
                val = val[:pos] + repl + val[pos + 1:]
                self._inj.counters["payload_bitflips"] += 1
            else:
                val = val[:max(1, len(val) // 2)]
                self._inj.counters["payload_truncates"] += 1
        return val

    def delete(self, key: str) -> None:
        self._roll("delete", key)
        self.inner.delete(key)

    def keys(self, prefix: str = ""):
        # Scans ride the same fault plane as point ops (a partition
        # blocks discovery too); op-filtered faults never name "keys",
        # so only total/unfiltered kinds apply.
        self._roll("keys", prefix)
        return self.inner.keys(prefix)


class BackendFaultyKV:
    """KVStore-shaped shim for ONE replica of a ReplicatedKV: enforces the
    ``kv_backend_kill`` (step-windowed total outage) and
    ``kv_backend_wipe`` (once: drop the whole keyspace, keep serving)
    kinds for its backend index. Sits INSIDE the quorum layer, so the
    replication math, not the retry plane, is what must absorb it."""

    def __init__(self, inner, faults: List[Dict[str, Any]],
                 injector: "FaultInjector", backend_index: int):
        self.inner = inner
        self._faults = [f for f in faults if f["backend"] == backend_index]
        self._inj = injector
        self.backend_index = int(backend_index)

    def _roll(self, op: str) -> None:
        step = self._inj.current_step
        for i, f in enumerate(self._faults):
            if f["kind"] == "kv_backend_wipe":
                if ("bwipe", self.backend_index, i) in self._inj._fired or \
                        step < f["step"]:
                    continue
                self._inj._fired.add(("bwipe", self.backend_index, i))
                # Wipe FIRST, then serve the op against the emptied
                # store: the lost-disk replica answers, wrongly.
                for k in list(self.inner.keys("")):
                    self.inner.delete(k)
                self._inj.counters["kv_backend_wipes"] += 1
            elif f["kind"] == "kv_backend_kill":
                if step < f["step"]:
                    continue
                if f["steps"] > 0 and step >= f["step"] + f["steps"]:
                    continue
                if ("bkill", self.backend_index, i) not in self._inj._fired:
                    self._inj._fired.add(("bkill", self.backend_index, i))
                    self._inj.counters["kv_backend_kills"] += 1
                self._inj.counters["kv_backend_drops"] += 1
                raise TransientKVError(
                    f"UNAVAILABLE: injected kv_backend_kill on backend "
                    f"{self.backend_index} {op} (step {step})")

    def set(self, key: str, value: str) -> None:
        self._roll("set")
        self.inner.set(key, value)

    def get(self, key: str, default: Optional[str] = None) -> Optional[str]:
        self._roll("get")
        return self.inner.get(key, default)

    def delete(self, key: str) -> None:
        self._roll("delete")
        self.inner.delete(key)

    def keys(self, prefix: str = ""):
        self._roll("keys")
        return self.inner.keys(prefix)


class FaultInjector:
    """One injector per process, owning the parsed spec, the fired-fault
    memory, and the fault counters the telemetry plane reports.

    Survives trainer restarts: the auto-resume loop constructs it once and
    threads it into each rebuilt trainer, so once-only faults
    (replica_crash, ckpt_corrupt) do not re-fire after recovery.
    """

    def __init__(self, spec: str, process_index: int = 0,
                 clock: Optional[Callable[[], float]] = None,
                 sleep: Optional[Callable[[float], None]] = None):
        import time
        self.spec = spec
        self.faults = parse_fault_spec(spec)
        self.process_index = int(process_index)
        self.clock = clock or time.monotonic
        self.sleep = sleep or time.sleep
        self._fired = set()
        self.current_step = 0
        self.counters: Dict[str, int] = {
            "kv_drops": 0, "kv_delays": 0, "crashes": 0,
            "ckpt_corruptions": 0, "grad_nans": 0, "leader_kills": 0,
            "kv_partition_drops": 0, "link_jitters": 0, "replica_kills": 0,
            "payload_bitflips": 0, "payload_truncates": 0, "grad_poisons": 0,
            "kv_backend_kills": 0, "kv_backend_wipes": 0,
            "kv_backend_drops": 0}

    # ---- KV plane ----
    @property
    def has_kv_faults(self) -> bool:
        return any(f["kind"] in _KV_FAULT_KINDS for f in self.faults)

    def wrap_kv(self, kv):
        kv_faults = [f for f in self.faults
                     if f["kind"] in _KV_FAULT_KINDS]
        if not kv_faults:
            return kv
        return FaultyKV(kv, kv_faults, self, self.sleep)

    @property
    def has_backend_faults(self) -> bool:
        return any(f["kind"] in _BACKEND_FAULT_KINDS for f in self.faults)

    def wrap_backend(self, kv, backend_index: int):
        """Per-replica shim for ReplicatedKV backends: only the
        ``kv_backend_*`` kinds naming ``backend_index`` apply. Applied
        INSIDE the quorum layer (``runtime/kvrep.py:build_replicated_kv``),
        so a killed or wiped backend exercises ejection and anti-entropy,
        never the caller-visible retry path."""
        faults = [f for f in self.faults
                  if f["kind"] in _BACKEND_FAULT_KINDS]
        if not any(f["backend"] == backend_index for f in faults):
            return kv
        return BackendFaultyKV(kv, faults, self, backend_index)

    # ---- step loop plane ----
    def maybe_crash(self, step: int) -> None:
        """Raise InjectedCrash when a replica_crash fault matches this
        process and step (once). Call at the top of the step loop — this
        call also advances ``current_step``, the clock the step-windowed
        faults (kv_partition) read."""
        self.current_step = max(self.current_step, int(step))
        for i, f in enumerate(self.faults):
            if f["kind"] != "replica_crash" or ("crash", i) in self._fired:
                continue
            if f["r"] == self.process_index and step >= f["step"]:
                self._fired.add(("crash", i))
                self.counters["crashes"] += 1
                raise InjectedCrash(
                    f"injected replica_crash r={f['r']} at step {step}")

    def maybe_kill_leader(self, step: int, is_leader: bool) -> None:
        """SIGKILL this process when a leader_kill fault matches the step
        AND this process holds leadership (once). Role-addressed: the
        caller reports its live role each step, so with elections on the
        victim is whoever holds the lease at that step. SIGKILL on
        purpose: no atexit, no finally blocks, no last heartbeat, the
        hardest death the election must recover from. The ``FAULT
        leader_kill`` line is printed first, and the launcher reads a log
        that ends with it as an intended death."""
        for i, f in enumerate(self.faults):
            if f["kind"] != "leader_kill" or ("lkill", i) in self._fired:
                continue
            if is_leader and step >= f["step"]:
                self._fired.add(("lkill", i))
                self.counters["leader_kills"] += 1
                import signal
                import sys
                print(f"{LEADER_KILL_LINE} SIGKILL process "
                      f"{self.process_index} (leader) at step {step}",
                      flush=True)
                sys.stdout.flush()
                os.kill(os.getpid(), signal.SIGKILL)

    def maybe_kill_replica(self, served: int) -> None:
        """SIGKILL this serving replica when a replica_kill fault matches
        this process and it has served >= ``served`` requests (once).
        The serving-plane analogue of ``maybe_kill_leader``: SIGKILL on
        purpose — no drain, no deregistration, no final heartbeat — so
        the router must notice via lease staleness/connection errors."""
        for i, f in enumerate(self.faults):
            if f["kind"] != "replica_kill" or ("rkill", i) in self._fired:
                continue
            if f["r"] == self.process_index and served >= f["served"]:
                self._fired.add(("rkill", i))
                self.counters["replica_kills"] += 1
                import signal
                import sys
                print(f"FAULT replica_kill: SIGKILL replica "
                      f"{self.process_index} after {served} served",
                      flush=True)
                sys.stdout.flush()
                os.kill(os.getpid(), signal.SIGKILL)

    def maybe_poison(self, step: int) -> bool:
        """True when a grad_nan fault matches this process and step (once):
        the trainer multiplies its participation mask by NaN before
        dispatch, so the poisoned value flows through the step's
        reductions like a genuine numeric blow-up."""
        for i, f in enumerate(self.faults):
            if f["kind"] != "grad_nan" or ("nan", i) in self._fired:
                continue
            if f["r"] == self.process_index and step >= f["step"]:
                self._fired.add(("nan", i))
                self.counters["grad_nans"] += 1
                return True
        return False

    def poison_scale(self, step: int) -> Optional[float]:
        """The grad_poison multiplier when a window is open for this
        process at ``step``, else None. NOT once-only: the window
        [step, step+steps) (steps=0: to the end of the run) stays open
        every step, so the quarantine sees a repeat offender, and closes
        on schedule, so readmission after healing is observable."""
        for f in self.faults:
            if f["kind"] != "grad_poison" or f["r"] != self.process_index:
                continue
            if step < f["step"]:
                continue
            if f["steps"] > 0 and step >= f["step"] + f["steps"]:
                continue
            self.counters["grad_poisons"] += 1
            return float(f["scale"])
        return None

    # ---- checkpoint plane ----
    def after_checkpoint(self, train_dir: str, step: int) -> None:
        """Corrupt the just-committed checkpoint when a ckpt_corrupt fault
        matches ``step`` (once) — simulates bit-rot/torn-write AFTER the
        atomic rename, which is exactly what the manifest must catch."""
        for i, f in enumerate(self.faults):
            if f["kind"] != "ckpt_corrupt" or ("ckpt", i) in self._fired:
                continue
            if step >= f["step"]:
                self._fired.add(("ckpt", i))
                path = os.path.join(train_dir, f"model_step_{step}",
                                    "state.msgpack")
                if corrupt_file(path, mode=f["mode"]):
                    self.counters["ckpt_corruptions"] += 1

    def snapshot(self) -> Dict[str, int]:
        return dict(self.counters)


def corrupt_file(path: str, mode: str = "flip") -> bool:
    """Damage ``path`` in place (test/chaos helper). flip: XOR one mid-file
    byte; truncate: keep the first half. Returns False if the file is
    missing/empty (nothing to corrupt)."""
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError:
        return False
    if not blob:
        return False
    if mode == "truncate":
        blob = blob[:len(blob) // 2]
    else:
        mid = len(blob) // 2
        blob = blob[:mid] + bytes([blob[mid] ^ 0xFF]) + blob[mid + 1:]
    with open(path, "wb") as f:
        f.write(blob)
    return True
