"""Epoch'd membership registry, the JAX package's
``elastic/membership.py``: the worker set is no longer frozen.

The reference fixed its worker set at launch (mpirun's hostfile IS the
membership); a lost worker was lost forever and a new one could not join.
Here membership is a small KV protocol layered on the heartbeat plane
(resilience/heartbeat.py):

- Every process ANNOUNCES itself: ``{run}/member/ann/{pid}`` holds a JSON
  ``{"action": "join"|"leave", "replicas": [...], "inc": n, "ts": t}``
  record. ``inc`` is the incarnation — it increments on every (re)join so
  a rejoin after eviction is observable as a distinct event.
- The LEADER folds announcements + heartbeat liveness into an epoch'd
  VIEW at step boundaries (``MembershipRegistry.update``): a member is
  ACTIVE when it has joined, not left, and its replicas' beats are fresh
  (never-beaten members get the same bootstrap grace heartbeats do). Any
  change to the active set bumps the membership epoch.
- The view is PUBLISHED (``{run}/member/view``) so followers and late
  joiners can read the current membership without re-deriving it — the
  late joiner's fast-forward path is: read the view, restore the latest
  valid checkpoint, announce join, and keep beating; the leader readmits
  it into the mask at the next step boundary.

The registry only computes and publishes; folding the mask into the
participation decision stays in ``Coordinator._decide_mask`` so the
never-wedge fallbacks apply to membership exactly as they do to
liveness.
"""

import json
import time
from typing import Callable, Dict, List, Optional

import numpy as np

__all__ = ["MemberAnnouncer", "MembershipRegistry", "read_view"]


def _default_replicas_of(pid: int, n_processes: int,
                         n_replicas: int) -> List[int]:
    """Contiguous replica ownership, the same split the trainers use:
    process k owns replicas [k*per, (k+1)*per) with per = n_replicas //
    n_processes (trainers guarantee divisibility)."""
    per = max(n_replicas // max(n_processes, 1), 1)
    lo = pid * per
    return [r for r in range(lo, min(lo + per, n_replicas))]


class MemberAnnouncer:
    """Per-process: announce join/leave and beat for the owned replicas.

    Owns a :class:`resilience.heartbeat.Heartbeat` so callers wire ONE
    object into the step loop; ``beat`` carries both liveness and (via the
    announcement record, written once per join) membership intent.
    """

    def __init__(self, kv, run_id: str, pid: int, replicas: List[int],
                 interval_s: float = 1.0,
                 clock: Optional[Callable[[], float]] = None):
        from ps_pytorch_tpu_torch.resilience.heartbeat import Heartbeat
        self.kv = kv
        self.run_id = run_id
        self.pid = int(pid)
        self.replicas = list(replicas)
        self.clock = clock or time.time
        self.heartbeat = Heartbeat(kv, run_id, replicas,
                                   interval_s=interval_s, clock=self.clock)
        self.incarnation = 0

    def _ann_key(self) -> str:
        return f"{self.run_id}/member/ann/{self.pid}"

    def _announce(self, action: str) -> None:
        self.kv.set(self._ann_key(), json.dumps({
            "action": action, "replicas": self.replicas,
            "inc": self.incarnation, "ts": round(self.clock(), 3)}))

    def join(self) -> int:
        """(Re)join: bump the incarnation past any previous announcement
        (a restarted process reads its own prior record back) and beat
        immediately so admission does not wait a heartbeat interval."""
        prev = self.kv.get(self._ann_key())
        if prev is not None:
            try:
                self.incarnation = int(json.loads(prev).get("inc", 0))
            except (ValueError, TypeError):
                pass
        self.incarnation += 1
        self._announce("join")
        self.heartbeat.beat(0, force=True)
        return self.incarnation

    def leave(self) -> None:
        """Graceful exit: the leader evicts on the announcement instead of
        waiting out the heartbeat timeout."""
        self._announce("leave")

    def beat(self, step: int, force: bool = False) -> bool:
        return self.heartbeat.beat(step, force=force)


class MembershipRegistry:
    """Leader-side: fold announcements + liveness into an epoch'd view.

    ``update(step)`` is called once per mask decision (step boundary); it
    is cheap (one KV read per process + per replica) and idempotent when
    nothing changed. The view epoch starts at 1 for the initial
    membership so "no view yet" (epoch 0) is distinguishable.
    """

    def __init__(self, kv, run_id: str, n_processes: int, n_replicas: int,
                 timeout_s: float = 3.0,
                 clock: Optional[Callable[[], float]] = None,
                 replicas_of: Optional[Callable[[int], List[int]]] = None,
                 max_events: int = 256):
        self.kv = kv
        self.run_id = run_id
        self.n_processes = int(n_processes)
        self.n_replicas = int(n_replicas)
        self.timeout_s = float(timeout_s)
        self.clock = clock or time.time
        self._replicas_of = replicas_of or (
            lambda pid: _default_replicas_of(pid, n_processes, n_replicas))
        self.epoch = 0
        self.members: List[int] = []
        self._incarnations: Dict[int, int] = {}
        self._mask = np.ones(self.n_replicas, np.float32)
        self.counters: Dict[str, int] = {
            "membership_changes": 0, "joins": 0, "leaves": 0, "evictions": 0}
        self.events: List[dict] = []
        self._max_events = int(max_events)

    # ---- fold ----
    def _read_announcements(self) -> Dict[int, dict]:
        out: Dict[int, dict] = {}
        for pid in range(self.n_processes):
            v = self.kv.get(f"{self.run_id}/member/ann/{pid}")
            if v is None:
                continue
            try:
                rec = json.loads(v)
                if rec.get("action") in ("join", "leave"):
                    out[pid] = rec
            except (ValueError, TypeError):
                continue  # a torn announcement is no announcement
        return out

    def _alive(self, pid: int, replicas: List[int]) -> bool:
        """Freshest beat over the process's replicas, with bootstrap
        grace: a member that never beat is alive (same contract as
        LivenessMonitor — masking the world out at startup wedges step 1)."""
        now = self.clock()
        seen = False
        for r in replicas:
            v = self.kv.get(f"{self.run_id}/hb/{r}")
            if v is None:
                continue
            try:
                _, ts = json.loads(v)
            except (ValueError, TypeError):
                continue
            seen = True
            if now - float(ts) <= self.timeout_s:
                return True
        return not seen

    def update(self, step: int) -> dict:
        """Recompute the active set; bump the epoch and publish on change.
        Returns the current view dict."""
        anns = self._read_announcements()
        active: List[int] = []
        for pid, rec in sorted(anns.items()):
            if rec["action"] != "join":
                continue
            replicas = [int(r) for r in rec.get("replicas", [])] or \
                self._replicas_of(pid)
            if self._alive(pid, replicas):
                active.append(pid)
        changed = active != self.members or \
            any(anns.get(p, {}).get("inc", 0) !=
                self._incarnations.get(p) for p in active)
        if changed:
            self._record_transitions(active, anns, step)
            self.members = active
            self._incarnations = {
                p: int(anns.get(p, {}).get("inc", 0)) for p in active}
            self.epoch += 1
            self.counters["membership_changes"] += 1
            mask = np.zeros(self.n_replicas, np.float32)
            for pid in active:
                replicas = [int(r) for r in
                            anns[pid].get("replicas", [])] or \
                    self._replicas_of(pid)
                for r in replicas:
                    if 0 <= r < self.n_replicas:
                        mask[r] = 1.0
            self._mask = mask
            self.publish(step)
        return self.view(step)

    def _record_transitions(self, active: List[int], anns: Dict[int, dict],
                            step: int) -> None:
        now = round(self.clock(), 3)
        for pid in active:
            if pid not in self.members or \
                    anns.get(pid, {}).get("inc", 0) != \
                    self._incarnations.get(pid):
                self.counters["joins"] += 1
                self._event({"event": "join", "pid": pid, "step": step,
                             "inc": anns.get(pid, {}).get("inc", 0),
                             "t": now})
        for pid in self.members:
            if pid in active:
                continue
            left = anns.get(pid, {}).get("action") == "leave"
            self.counters["leaves" if left else "evictions"] += 1
            self._event({"event": "leave" if left else "evict",
                         "pid": pid, "step": step, "t": now})

    def _event(self, e: dict) -> None:
        if len(self.events) < self._max_events:
            self.events.append(e)

    def evicted(self, pid: int) -> bool:
        """True when process ``pid`` announced a join and its beats are
        older than the deadline: dead without leaving, what ``update``
        counts as an eviction. (The port's addition: the process that
        serves the store stops waiting for such a process at exit.)"""
        ann = self._read_announcements().get(pid)
        return ann is not None and ann["action"] == "join" and \
            not self._alive(pid, [int(r) for r in ann.get("replicas", [])]
                            or self._replicas_of(pid))

    # ---- view ----
    def mask(self) -> np.ndarray:
        """float32[n_replicas]; all-ones until the first member joins so
        a run without announcers degrades to the static world."""
        if self.epoch == 0 or not self._mask.any():
            return np.ones(self.n_replicas, np.float32)
        return self._mask

    def view(self, step: int = 0) -> dict:
        return {"epoch": self.epoch, "members": list(self.members),
                "mask": self.mask().astype(int).tolist(), "step": int(step),
                "ts": round(self.clock(), 3)}

    def publish(self, step: int) -> None:
        self.kv.set(f"{self.run_id}/member/view",
                    json.dumps(self.view(step)))

    def snapshot(self) -> Dict[str, int]:
        out = dict(self.counters)
        out["epoch"] = self.epoch
        out["world_size"] = len(self.members)
        return out


def read_view(kv, run_id: str) -> Optional[dict]:
    """Follower / late-joiner side: the leader's last published view, or
    None before the first publish. The fast-forward recipe for a joiner:
    ``read_view`` -> restore the latest valid checkpoint
    (``runtime/checkpoint.py:load_latest_valid``) ->
    ``MemberAnnouncer.join()`` -> beat."""
    v = kv.get(f"{run_id}/member/view")
    if v is None:
        return None
    try:
        return json.loads(v)
    except (ValueError, TypeError):
        return None
