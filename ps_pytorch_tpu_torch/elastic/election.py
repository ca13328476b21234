"""Lease-based leader election over the coordination KV: the JAX
package's ``elastic/election.py``. The lease value is its JSON
``[epoch, owner, ts]``, byte for byte, so a process of either package
reads the other's lease on a shared backend.

The reference's master was an address: whoever you launched as rank 0 IS
the leader, forever, and its death kills the run
(``sync_replicas_master_nn.py``). Here leadership is a LEASE — one small
KV record any process can claim when the holder stops refreshing it —
so the control plane survives the exact failure the reference could not.

Key layout (all under ``{run_id}/elect/``):

- ``lease``              JSON ``[epoch, owner, ts]`` — the authority
                         record. Refreshed by the owner every
                         ``interval_s``; stale after ``timeout_s``.
- ``cand/{epoch}/{pid}`` candidacy marker for one campaign round.

The coordination-service KV has no transactions, so compare-and-claim is
built from last-writer-wins writes plus a read-back: every candidate for
epoch E writes its candidacy, waits ``settle_s`` for concurrent
candidacies to land, deterministically picks the winner (lowest process
index, with ``preferred`` honoured when it is a candidate), and only the
winner writes the lease — then re-reads it after another settle to detect
the losing side of a claim race. Whatever interleaving the KV serves, all
processes converge on the same ``[epoch, owner]`` because the winner
function is deterministic in the candidate set and a higher epoch always
supersedes.

Fencing: the epoch number IS the fence token. A deposed leader's refresh
sees a lease with a higher epoch (or a different owner at its own epoch)
and raises :class:`Deposed` instead of overwriting it — its stale
mask/lease writes stop at the source. The Coordinator demotes it to
follower; nothing it wrote after losing the lease is ever authoritative.

Clock discipline matches resilience/heartbeat.py: one shared clock domain
(wall time in production, a single ManualClock in tests), and the refresh
throttle (``_last``) is RESET on every successful claim so a deposed
leader's throttle state cannot leak into its next epoch — without the
reset, a re-elected process could inherit ``_last`` from the old epoch and
skip its first refresh, presenting a stale lease to every follower.
"""

import json
import time
from typing import Callable, Dict, List, Optional, Tuple

__all__ = ["Deposed", "ElectionFailed", "LeaderElection"]


class Deposed(RuntimeError):
    """A leader's refresh found the lease claimed by a higher epoch (or a
    different owner at its own epoch): this process lost leadership and
    must demote itself before publishing anything else."""


class ElectionFailed(RuntimeError):
    """No leader emerged after ``max_campaigns`` rounds — the KV is
    unreachable or partitioned. Escalate (auto-resume restarts the
    process as a follower; a healed partition elects normally)."""


class LeaderElection:
    """One process's view of the leadership lease.

    The object is long-lived: the same instance carries a process through
    follower → candidate → leader → deposed transitions, tracking the
    observed ``epoch``/``owner`` and its own role in ``is_leader``.
    """

    def __init__(self, kv, run_id: str, pid: int, n_processes: int,
                 interval_s: float = 1.0, timeout_s: float = 0.0,
                 settle_s: float = 0.05, preferred: int = 0,
                 clock: Optional[Callable[[], float]] = None,
                 sleep: Optional[Callable[[float], None]] = None,
                 max_campaigns: int = 5):
        self.kv = kv
        self.run_id = run_id
        self.pid = int(pid)
        self.n = int(n_processes)
        self.interval_s = float(interval_s)
        self.timeout_s = float(timeout_s) or 3.0 * self.interval_s
        self.settle_s = float(settle_s)
        self.preferred = int(preferred)
        self.clock = clock or time.time
        self.sleep = sleep or time.sleep
        self.max_campaigns = int(max_campaigns)
        self.epoch = 0            # highest epoch observed on the lease
        self.owner: Optional[int] = None
        self.is_leader = False
        self._last = float("-inf")  # refresh throttle (reset per epoch)
        self.stats: Dict[str, int] = {
            "campaigns": 0, "wins": 0, "deposed": 0}
        self.events: List[dict] = []

    # ---- lease record ----
    @property
    def _lease_key(self) -> str:
        return f"{self.run_id}/elect/lease"

    def read_lease(self) -> Optional[Tuple[int, int, float]]:
        """``(epoch, owner, ts)`` or None when never claimed. A torn or
        garbled lease reads as absent — the campaign path handles it the
        same way as a missing one (claim the next epoch)."""
        v = self.kv.get(self._lease_key)
        if v is None:
            return None
        try:
            epoch, owner, ts = json.loads(v)
            return int(epoch), int(owner), float(ts)
        except (ValueError, TypeError):
            return None

    def lease_age(self) -> Optional[float]:
        lease = self.read_lease()
        if lease is None:
            return None
        return self.clock() - lease[2]

    # ---- bootstrap ----
    def claim_initial(self) -> int:
        """The configured initial leader claims epoch 1 unconditionally at
        startup (there is nobody to race: followers only campaign after a
        stale lease, and the lease does not exist yet). Returns the epoch."""
        return self._claim(max(self.epoch, 0) + 1)

    # ---- leader side ----
    def refresh(self, step: int = 0) -> bool:
        """Refresh the lease (throttled write) after an UNTHROTTLED
        ownership check — the check is the fence: a deposed leader must
        learn it lost on the very next refresh attempt, not one interval
        later. Returns True when the lease record was (re)written."""
        if not self.is_leader:
            return False
        lease = self.read_lease()
        if lease is not None:
            epoch, owner, _ = lease
            if epoch > self.epoch or (epoch == self.epoch and
                                      owner != self.pid):
                my_epoch = self.epoch
                self.is_leader = False
                self.stats["deposed"] += 1
                self.events.append({"event": "deposed", "pid": self.pid,
                                    "epoch": epoch, "owner": owner,
                                    "t": round(self.clock(), 3)})
                self.epoch, self.owner = epoch, owner
                raise Deposed(
                    f"process {self.pid} deposed: lease now epoch {epoch} "
                    f"owner {owner} (was epoch {my_epoch})")
        now = self.clock()
        if now - self._last < self.interval_s:
            return False
        self._last = now
        self.kv.set(self._lease_key,
                    json.dumps([self.epoch, self.pid, now]))
        return True

    # ---- follower side ----
    def check(self) -> str:
        """Lease status for the follower's mask wait: ``"none"`` (never
        claimed — bootstrap grace), ``"fresh"``, or ``"stale"``. Updates
        the observed epoch/owner so a newly-claimed lease is followed
        without a campaign."""
        lease = self.read_lease()
        if lease is None:
            return "none"
        epoch, owner, ts = lease
        if epoch >= self.epoch:
            self.epoch, self.owner = epoch, owner
        if self.clock() - ts > self.timeout_s:
            return "stale"
        return "fresh"

    # ---- the campaign ----
    def campaign(self) -> bool:
        """Run election rounds until a leader holds a fresh lease. Returns
        True when this process won (``is_leader`` set, throttle reset so
        the first refresh of the new epoch always writes). Raises
        :class:`ElectionFailed` when ``max_campaigns`` rounds produce no
        leader."""
        for _ in range(self.max_campaigns):
            self.stats["campaigns"] += 1
            lease = self.read_lease()
            if lease is not None:
                epoch, owner, ts = lease
                if self.clock() - ts <= self.timeout_s and \
                        epoch >= self.epoch:
                    # Someone (re)claimed while we were deciding to run.
                    self._follow(epoch, owner)
                    return owner == self.pid and self.is_leader
                target = max(epoch, self.epoch) + 1
            else:
                target = max(self.epoch, 0) + 1
            # Candidacy: announce, let concurrent candidates land, then
            # pick the same winner everywhere (deterministic in the set).
            self.kv.set(f"{self.run_id}/elect/cand/{target}/{self.pid}",
                        json.dumps([round(self.clock(), 3)]))
            self.sleep(self.settle_s)
            lease = self.read_lease()
            if lease is not None and lease[0] >= target and \
                    self.clock() - lease[2] <= self.timeout_s:
                self._follow(lease[0], lease[1])
                return False
            cands = self._candidates(target)
            winner = self.preferred if self.preferred in cands \
                else min(cands)
            if winner == self.pid:
                self._claim(target)
                # Read-back: a concurrent claimer with a different
                # candidate view may have written after us.
                self.sleep(self.settle_s)
                lease = self.read_lease()
                if lease is not None and (lease[0] > target or
                                          lease[1] != self.pid):
                    self._follow(lease[0], lease[1])
                    return False
                self.stats["wins"] += 1
                self.events.append({"event": "elected", "pid": self.pid,
                                    "epoch": target,
                                    "t": round(self.clock(), 3)})
                return True
            # Wait (bounded) for the winner's claim; a winner that died
            # between candidacy and claim leaves the lease untouched and
            # the next round targets a higher epoch.
            waited = 0.0
            poll = max(self.settle_s, 1e-3)
            while waited <= self.timeout_s:
                lease = self.read_lease()
                if lease is not None and lease[0] >= target and \
                        self.clock() - lease[2] <= self.timeout_s:
                    self._follow(lease[0], lease[1])
                    return False
                self.sleep(poll)
                waited += poll
        raise ElectionFailed(
            f"no leader after {self.max_campaigns} campaign rounds "
            f"(process {self.pid}, last observed epoch {self.epoch})")

    # ---- internals ----
    def _candidates(self, epoch: int) -> List[int]:
        cands = [p for p in range(self.n)
                 if self.kv.get(f"{self.run_id}/elect/cand/{epoch}/{p}")
                 is not None]
        return cands or [self.pid]

    def _claim(self, epoch: int) -> int:
        self.epoch = int(epoch)
        self.owner = self.pid
        self.is_leader = True
        self.kv.set(self._lease_key,
                    json.dumps([self.epoch, self.pid, self.clock()]))
        # Per-epoch throttle reset: the claim write IS the new epoch's
        # first refresh — a _last inherited from a deposed epoch must not
        # suppress or distort the new epoch's cadence.
        self._last = self.clock()
        return self.epoch

    def _follow(self, epoch: int, owner: int) -> None:
        was_leader = self.is_leader
        self.epoch, self.owner = int(epoch), int(owner)
        self.is_leader = (owner == self.pid) and was_leader

    def snapshot(self) -> Dict[str, int]:
        out = dict(self.stats)
        out["epoch"] = self.epoch
        return out


def group_election(kv, run_id: str, gid: int, pid: int, n_processes: int,
                   preferred: int, **kw) -> LeaderElection:
    """A group-scoped election for the hierarchical sync plane: same
    machinery, namespaced lease (``{run_id}/g{gid}/elect/...``) so each
    sync group elects its aggregator independently. Candidacy keys are
    only ever written by group members (non-members never construct this
    object), and the campaign's range(n) scan simply finds no candidates
    outside the group — global pids work unchanged."""
    return LeaderElection(kv, f"{run_id}/g{gid}", pid, n_processes,
                          preferred=preferred, **kw)
