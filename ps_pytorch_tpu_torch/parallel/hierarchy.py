"""Partition-tolerant hierarchical multi-hop gradient sync over the KV: the
JAX package's ``parallel/hierarchy.py``.

The flat async wire is a leader <-> followers star: every slice publishes
its whole payload straight to the root, so N slices cost N slow
inter-region round-trips a round, and one partitioned slice looks like one
slow slice. This module adds the tree (DynamiQ-style multi-hop aggregation
with per-hop recompression, arXiv 2602.08923; ACE-Sync per-link intervals,
arXiv 2512.18127), with robustness first: a partitioned subtree degrades
the run, it never kills it.

Topology (2 tiers, the plan extensible to N):

    members --(fast intra-group link)--> group aggregator
    group aggregators --(slow inter-region link)--> root

- :class:`HierarchyPlan`: contiguous groups over slice ids; the lowest
  member is the preferred aggregator (the elastic plane's lowest-pid
  tie-break).
- :class:`GroupAggregator`: the tier-1 hop. It pools member payloads in a
  :class:`StaleGradientAggregator` (the compressed-domain
  ``sum_init/sum_add/sum_finish``), then re-encodes the group average once,
  so the up-link carries one payload a group instead of one a member. The
  re-encode rounds to the codec's lattice (at most one int8lat step a
  hop); the hop's error feedback carries that residual across rounds.
- :class:`RootAggregator`: the tier-2 pool of ``(gid, step, wsum,
  payloads)`` group aggregates, each weighted ``wsum * decay**staleness``
  (the flat average exactly when everything is fresh), K-of-N over groups,
  and the subtree lifecycle: a group silent past the staleness limit is
  declared partitioned (the run continues on the survivors), and one that
  contributes fresh again is re-grafted; its pre-partition aggregates are
  past the limit and the usual staleness filter drops them.
- :class:`HierarchicalAggregator`: both tiers in one process, behind
  ``StaleGradientAggregator``'s surface (``MultiSliceTrainer``).
- :class:`HierarchicalKVTransport`: the cross-process plane of the async
  trainer: a channel a link (``{run}/hgrad/{gid}/{sid}`` intra-group,
  ``{run}/hagg/{gid}`` up-links), jittered retry a hop
  (``resilience/retry.py``), aggregator failover through a group-scoped
  lease (``elastic/election.py``), and reads and writes that absorb
  transient errors, so a partitioned process degrades instead of crashing.

Every hop records a ``hier_hop`` span; the trainers turn the counters
into ``telemetry/registry.py``'s ``HIERARCHY_COUNTERS``.

Everything here runs on the host in numpy, as in the JAX package. Member
gradients may arrive as tensors on their device (``encode_leaves`` takes
them); every payload, average and residual is numpy. Trees flatten with
sorted keys (``async_dp.tree_flatten``, the order of ``jax.tree.flatten``),
payload dicts as leaves wherever payload trees are flattened.
"""

import json
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ps_pytorch_tpu_torch.compression.codecs import (
    HOMOMORPHIC_GRAD_CODECS, ErrorFeedback, encode_leaves, get_grad_codec,
    is_payload, require_codec,
)
from ps_pytorch_tpu_torch.elastic.election import (
    Deposed, ElectionFailed, group_election,
)
from ps_pytorch_tpu_torch.parallel.async_dp import (
    StaleGradientAggregator, tree_flatten, tree_unflatten,
)
from ps_pytorch_tpu_torch.parallel.transport import KVPytreeChannel
from ps_pytorch_tpu_torch.resilience.retry import (
    RetryPolicy, call_with_retry, is_retryable,
)
from ps_pytorch_tpu_torch.telemetry.trace import span as _span


# ---------------------------------------------------------------------------
# Topology
# ---------------------------------------------------------------------------

class HierarchyPlan:
    """Deterministic tiered grouping of ``n_slices`` contributor ids.

    Groups are contiguous (slice ``s`` belongs to group ``s //
    group_size``): slice ids encode locality (process order follows the
    machines' layout), and contiguity is what the subtree-scoped fault
    (``kv_partition:group=``) keys on. ``group_size=0`` picks ~sqrt(n),
    the balance of hop count and width for 2 tiers.
    """

    def __init__(self, n_slices: int, group_size: int = 0):
        if n_slices < 1:
            raise ValueError("need at least one slice")
        if group_size < 0:
            raise ValueError(f"group_size={group_size} (must be >= 0)")
        self.n = int(n_slices)
        if group_size == 0:
            group_size = max(1, int(round(float(np.sqrt(self.n)))))
        self.group_size = min(int(group_size), self.n)
        self.n_groups = -(-self.n // self.group_size)   # ceil div

    def group_of(self, slice_id: int) -> int:
        if not (0 <= slice_id < self.n):
            raise ValueError(f"slice_id {slice_id} out of range")
        return slice_id // self.group_size

    def members(self, gid: int) -> List[int]:
        if not (0 <= gid < self.n_groups):
            raise ValueError(f"group {gid} out of range")
        lo = gid * self.group_size
        return list(range(lo, min(lo + self.group_size, self.n)))

    def aggregator_of(self, gid: int) -> int:
        """The preferred aggregator: the lowest member id, the elastic
        election's tie-break, so the first campaign after a failover
        converges on the same pick from every member."""
        return self.members(gid)[0]

    def levels(self) -> List[List[List[int]]]:
        """The topology as tiers of groups: tier 0 groups the members,
        each further tier groups the previous tier's aggregates until one
        group remains."""
        out = [[self.members(g) for g in range(self.n_groups)]]
        width = self.n_groups
        while width > 1:
            ids = list(range(width))
            tier = [ids[i:i + self.group_size]
                    for i in range(0, width, self.group_size)]
            out.append(tier)
            width = len(tier)
        return out

    def describe(self) -> dict:
        return {"n_slices": self.n, "group_size": self.group_size,
                "n_groups": self.n_groups,
                "aggregators": [self.aggregator_of(g)
                                for g in range(self.n_groups)]}


# ---------------------------------------------------------------------------
# Tier-1 hop: members -> group aggregate, re-encoded once
# ---------------------------------------------------------------------------

class GroupAggregator:
    """One group's pool and re-encode hop.

    The member payloads pool in a :class:`StaleGradientAggregator`; the
    decoded group average is re-encoded once, so the up-link carries one
    payload tree and ``(step, wsum)``. The re-encode's slice identity is
    ``n_slices + gid``, outside the member id space, so randk's
    per-sender seeding never collides with a member's.
    """

    def __init__(self, plan: HierarchyPlan, gid: int, codec: str,
                 staleness_limit: int = 4, topk_frac: float = 0.01,
                 hop_ef: bool = False, ef_clip: float = 0.0,
                 integrity: Any = None):
        require_codec("grad_codec", codec, HOMOMORPHIC_GRAD_CODECS)
        self.plan = plan
        self.gid = int(gid)
        self.codec = codec
        self.topk_frac = float(topk_frac)
        # No decay inside a group: members share a fast link, so their
        # staleness spread is noise. The root decays once, from the hop's
        # step. ``integrity`` (a GradIntegrity over the MEMBER id space)
        # screens member payloads here, before the group's sum.
        self.inner = StaleGradientAggregator(
            plan.n, staleness_limit=staleness_limit, staleness_decay=0.0,
            num_aggregate=0, compress=True, codec=codec,
            topk_frac=topk_frac, integrity=integrity)
        self._ef = ErrorFeedback(clip=ef_clip) if hop_ef else None
        self.hops = 0

    def submit_encoded(self, slice_id: int, step: int, tree: Any) -> None:
        if self.plan.group_of(slice_id) != self.gid:
            raise ValueError(f"slice {slice_id} is not in group {self.gid}")
        self.inner.submit_encoded(slice_id, step, tree)

    def pending(self) -> Dict[int, int]:
        return self.inner.pending()

    def collect_and_reencode(self, current_step: int
                             ) -> Optional[Tuple[int, float, Any]]:
        """-> (step, wsum, re-encoded payload tree), or None when no fresh
        member contribution exists. ``step`` is the newest member step in
        the aggregate (the root must not punish a group for pooling one
        older member); ``wsum`` is the weight the root gives it, so the
        end-to-end average is the flat one."""
        steps = self.inner.pending()
        with _span("hier_hop", tier=1, group=self.gid,
                   step=current_step) as sargs:
            avg, info = self.inner.collect(current_step)
            if avg is None:
                return None
            used = info["used"]
            wsum = float(sum(info["weights"].values()))
            step = max(steps[sid] for sid in used)
            leaves, treedef = tree_flatten(avg)
            payloads = encode_leaves(
                self.codec, [np.asarray(l, np.float32) for l in leaves],
                slice_id=self.plan.n + self.gid, step=step,
                frac=self.topk_frac, ef=self._ef)
            # The up-link carries the gradient tree's shape with payload
            # dicts at the leaves, so the root's one decode lands in the
            # structure the optimizer takes.
            tree = tree_unflatten(treedef, payloads)
            self.inner.consume(used)
            self.hops += 1
            if sargs is not None:
                sargs["members"] = len(used)
                sargs["wsum"] = wsum
        return step, wsum, tree

    def drop_older_than(self, current_step: int) -> int:
        return self.inner.drop_older_than(current_step)

    # -- the hop's EF checkpoint surface (the in-process path only; the KV
    #    path runs its hops without EF, so no residual lives outside the
    #    checkpoint) --
    def ef_state_dict(self) -> Dict[str, Any]:
        return self._ef.state_dict() if self._ef is not None else {}

    def load_ef_state(self, state: Dict[str, Any]) -> None:
        if self._ef is not None:
            self._ef.load_state_dict(state or {})


# ---------------------------------------------------------------------------
# Tier-2 pool: group aggregates -> root average + subtree lifecycle
# ---------------------------------------------------------------------------

class RootAggregator:
    """The root's pool of group aggregates, with the subtree lifecycle.

    Weighting: an aggregate carrying ``wsum`` (its members' weights)
    counts ``wsum * decay**staleness``. Everything fresh, that is the flat
    weighted average exactly: sum_g(w_g * avg_g) / sum_g(w_g) =
    sum_i(g_i) / N. ``num_aggregate`` counts GROUPS (K-of-N a tier).

    Lifecycle: a group whose last contribution is older than
    ``staleness_limit`` turns partitioned (``on_event("partition", gid,
    step, silent)``, once an outage); the root keeps applying updates
    from the survivors, counted in ``degraded_steps`` an applied update. A
    fresh contribution from a partitioned group re-grafts it
    (``on_event("regraft", gid, step, staleness)``); what it published
    before the partition is past the limit, so the staleness filter drops
    it and catching up needs no path of its own.
    """

    def __init__(self, n_groups: int, codec: str, staleness_limit: int = 4,
                 staleness_decay: float = 0.0, num_aggregate: int = 0,
                 on_event: Optional[Callable[[str, int, int, int], None]]
                 = None, integrity: Any = None):
        require_codec("grad_codec", codec, HOMOMORPHIC_GRAD_CODECS)
        if n_groups < 1:
            raise ValueError("need at least one group")
        if num_aggregate > n_groups:
            raise ValueError(
                f"num_aggregate {num_aggregate} > n_groups {n_groups}")
        self.n_groups = int(n_groups)
        self.codec = codec
        self.limit = int(staleness_limit)
        self.decay = float(staleness_decay)
        self.k = int(num_aggregate)
        self.on_event = on_event
        # The root's screen (a GradIntegrity over the GROUP id space, a
        # strike ledger of its own): a poisoned or malformed aggregate is
        # demoted before the sum, as at the member hop.
        self.integrity = integrity
        # gid -> (step, wsum, payload leaves, treedef)
        self._pool: Dict[int, Tuple[int, float, List[Any], Any]] = {}
        self._last_step: Dict[int, int] = {}
        self._healthy: Dict[int, bool] = {g: True
                                          for g in range(self.n_groups)}
        self.counters: Dict[str, int] = {
            "hops": 0, "partitions": 0, "regrafts": 0,
            "degraded_steps": 0}

    def submit_group(self, gid: int, step: int, wsum: float,
                     tree: Any) -> None:
        """Latest wins a group, as in the member pool. The payload dicts
        are the flatten unit: one payload a gradient leaf."""
        if not (0 <= gid < self.n_groups):
            raise ValueError(f"group {gid} out of range")
        if wsum <= 0:
            raise ValueError(f"group {gid} wsum={wsum} (must be > 0)")
        leaves, treedef = tree_flatten(tree, is_leaf=is_payload)
        self._pool[gid] = (int(step), float(wsum), leaves, treedef)
        self._last_step[gid] = max(self._last_step.get(gid, -1), int(step))

    def groups_healthy(self) -> int:
        return sum(1 for h in self._healthy.values() if h)

    def _emit(self, kind: str, gid: int, step: int, staleness: int) -> None:
        if self.on_event is not None:
            self.on_event(kind, gid, step, staleness)

    def _update_lifecycle(self, current_step: int,
                          used: List[int]) -> None:
        for gid in range(self.n_groups):
            last = self._last_step.get(gid, None)
            stale = (current_step - last) if last is not None else None
            if gid in used:
                if not self._healthy[gid]:
                    self._healthy[gid] = True
                    self.counters["regrafts"] += 1
                    self._emit("regraft", gid, current_step,
                               0 if stale is None else stale)
                continue
            # Not contributing this round: silent past the limit is a
            # partition (declared once an outage). A group that never
            # reported counts from step 0 by the same rule.
            silent = current_step if last is None else current_step - last
            if silent > self.limit and self._healthy[gid]:
                self._healthy[gid] = False
                self.counters["partitions"] += 1
                self._emit("partition", gid, current_step, silent)

    def collect(self, current_step: int) -> Tuple[Optional[Any], dict]:
        """StaleGradientAggregator.collect's contract over groups: ->
        (average tree or None, {"used", "dropped_stale", "weights",
        "degraded"}). The lifecycle moves inside this call: collect is
        the root's clock tick."""
        fresh = []
        dropped = []
        for gid, (step, wsum, leaves, treedef) in self._pool.items():
            staleness = current_step - step
            if staleness < 0 or staleness > self.limit:
                dropped.append(gid)
                continue
            fresh.append((staleness, gid, wsum, leaves, treedef))
        rejected: Dict[int, str] = {}
        if self.integrity is not None and fresh:
            # As at the member tier: screen before the K cutoff and
            # consume the rejects (absent this round; the lifecycle sees
            # silence, not a crash).
            admitted, rejected = self.integrity.screen(
                [(gid, leaves) for _, gid, _, leaves, _ in fresh],
                step=current_step)
            if rejected:
                ok = set(admitted)
                fresh = [t for t in fresh if t[1] in ok]
                for gid in rejected:
                    self._pool.pop(gid, None)
        fresh.sort(key=lambda t: (t[0], t[1]))
        if self.k > 0:
            fresh = fresh[:self.k]
        used = [gid for _, gid, _, _, _ in fresh]
        self._update_lifecycle(current_step, used)
        if not fresh:
            info = {"used": [], "dropped_stale": dropped,
                    "weights": {}, "degraded": False}
            if self.integrity is not None:
                info["rejected"] = rejected
            return None, info
        with _span("hier_hop", tier=2, step=current_step,
                   groups=len(fresh)) as sargs:
            codec = get_grad_codec(self.codec)
            treedef_out = fresh[0][4]
            shapes = [codec.payload_shape(p) for p in fresh[0][3]]
            states = [codec.sum_init() for _ in fresh[0][3]]
            weights = {}
            wtot = 0.0
            for staleness, gid, wsum, payloads, _ in fresh:
                w = wsum * (self.decay ** staleness
                            if self.decay > 0 else 1.0)
                weights[gid] = w
                for st, p in zip(states, payloads):
                    codec.sum_add(st, p, w)
                wtot += w
            avg = [codec.sum_finish(st, wtot, shape)
                   for st, shape in zip(states, shapes)]
            degraded = len(used) < self.n_groups
            if degraded:
                self.counters["degraded_steps"] += 1
            self.counters["hops"] += 1
            if sargs is not None:
                sargs["degraded"] = degraded
        info = {"used": used, "dropped_stale": dropped,
                "weights": weights, "degraded": degraded}
        if self.integrity is not None:
            info["rejected"] = rejected
        return tree_unflatten(treedef_out, avg), info

    def consume(self, gids) -> None:
        for gid in gids:
            self._pool.pop(gid, None)

    def drop_older_than(self, current_step: int) -> int:
        dead = [gid for gid, (step, _, _, _) in self._pool.items()
                if current_step - step > self.limit]
        for gid in dead:
            del self._pool[gid]
        return len(dead)

    def snapshot(self) -> Dict[str, int]:
        out = dict(self.counters)
        out["groups_healthy"] = self.groups_healthy()
        return out


# ---------------------------------------------------------------------------
# In-process composition (MultiSliceTrainer's aggregator)
# ---------------------------------------------------------------------------

class HierarchicalAggregator:
    """Both tiers behind StaleGradientAggregator's surface, so
    ``--sync-topology hier`` swaps into MultiSliceTrainer unchanged.

    submit() runs the member-side encode (with a member's EF when asked)
    into the member pool; collect() routes pooled payloads to their group
    pools every ``intra_every`` rounds (latest wins) and runs the group
    hops only on ``inter_every`` rounds: a hop's output always goes up, so
    no computed aggregate is discarded short of the root. ``info["used"]``
    names the MEMBER ids whose contribution is in the returned average
    (non-empty exactly when the average is not None), so the trainer's
    apply gate and its consume / GC calls keep their meaning.

    ``num_aggregate`` counts GROUPS at the root; a member count from a
    flat config is clamped to the plan's group count.
    """

    def __init__(self, n_slices: int, group_size: int = 0,
                 staleness_limit: int = 4, staleness_decay: float = 0.0,
                 num_aggregate: int = 0, codec: str = "int8lat",
                 topk_frac: float = 0.01, error_feedback: bool = False,
                 ef_clip: float = 0.0,
                 hop_ef: bool = True, intra_every: int = 1,
                 inter_every: int = 1,
                 on_event: Optional[Callable[[str, int, int, int], None]]
                 = None, integrity: Any = None,
                 root_integrity: Any = None):
        self.plan = HierarchyPlan(n_slices, group_size)
        self.codec = codec
        self.topk_frac = float(topk_frac)
        self.error_feedback = bool(error_feedback)
        self.intra_every = max(1, int(intra_every))
        self.inter_every = max(1, int(inter_every))
        # Member tier: one pool for the member-side encode (its EF a
        # member); the hop EF carries the re-encode's rounding when the
        # group average is off the lattice.
        self._members = StaleGradientAggregator(
            n_slices, staleness_limit=staleness_limit, staleness_decay=0.0,
            num_aggregate=0, compress=True, codec=codec,
            topk_frac=topk_frac, error_feedback=error_feedback,
            ef_clip=ef_clip)
        # Member ids are unique across groups, so one member-space
        # GradIntegrity serves every group hop; the root has its own over
        # the group ids.
        self._groups = [GroupAggregator(self.plan, g, codec,
                                        staleness_limit=staleness_limit,
                                        topk_frac=topk_frac, hop_ef=hop_ef,
                                        ef_clip=ef_clip,
                                        integrity=integrity)
                        for g in range(self.plan.n_groups)]
        self.root = RootAggregator(
            self.plan.n_groups, codec, staleness_limit=staleness_limit,
            staleness_decay=staleness_decay,
            num_aggregate=min(int(num_aggregate), self.plan.n_groups),
            on_event=on_event, integrity=root_integrity)
        # gid -> the member ids that fed the group's pending aggregate,
        # replaced with it (latest wins) and popped when the root
        # consumes it.
        self._group_members: Dict[int, List[int]] = {}
        self._rounds = 0

    # ---- StaleGradientAggregator's surface ----
    def submit(self, slice_id: int, step: int, grads: Any) -> None:
        self._members.submit(slice_id, step, grads)

    def submit_encoded(self, slice_id: int, step: int, tree: Any) -> None:
        self._members.submit_encoded(slice_id, step, tree)

    def collect(self, current_step: int) -> Tuple[Optional[Any], dict]:
        self._rounds += 1
        if self._rounds % self.intra_every == 0:
            # Tier-1 routing: the pooled member payloads move to their
            # group pools (latest wins).
            pend = self._members.pending()
            for sid, step in pend.items():
                gid = self.plan.group_of(sid)
                _, leaves, treedef = self._members._pool[sid]
                self._groups[gid].inner._pool[sid] = (step, leaves, treedef)
            self._members.consume(pend.keys())
        if self._rounds % self.inter_every == 0:
            # The group hops run only when the up-link is due: a hop
            # consumes its members' payloads, so its aggregate must travel
            # up; between those rounds the payloads stay pooled.
            for g in self._groups:
                before = set(g.pending())
                out = g.collect_and_reencode(current_step)
                if out is None:
                    continue
                step, wsum, tree = out
                self.root.submit_group(g.gid, step, wsum, tree)
                self._group_members[g.gid] = sorted(
                    s for s in before if s not in g.pending())
        avg, info = self.root.collect(current_step)
        info = dict(info)
        info["used_groups"] = info["used"]
        # The members whose contribution is IN the returned average (a
        # K-of-N leftover applied on a later round included).
        info["used"] = sorted({m for gid in info["used_groups"]
                               for m in self._group_members.get(gid, ())})
        if avg is not None:
            self.root.consume(info["used_groups"])
            for gid in info["used_groups"]:
                self._group_members.pop(gid, None)
        return avg, info

    def consume(self, slice_ids) -> None:
        # Every tier consumes inside collect(); what the member pool holds
        # now is NEWER than what was applied, so the trainer's consume of
        # the applied member ids must not clear it.
        pass

    def drop_older_than(self, current_step: int) -> int:
        n = self._members.drop_older_than(current_step)
        for g in self._groups:
            n += g.drop_older_than(current_step)
        n += self.root.drop_older_than(current_step)
        for gid in list(self._group_members):
            if gid not in self.root._pool:   # aggregate GC'd: record too
                del self._group_members[gid]
        return n

    def wire_bytes(self) -> int:
        return self._members.wire_bytes()

    # ---- checkpoint surface: member EF + each group's hop EF ----
    def ef_state_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"members": self._members.ef_state_dict()}
        for g in self._groups:
            st = g.ef_state_dict()
            if st:
                out[f"g{g.gid}"] = st
        return out

    def load_ef_state(self, state: Dict[str, Any]) -> None:
        state = state or {}
        if "members" in state or any(k.startswith("g") for k in state):
            self._members.load_ef_state(state.get("members", {}))
            for g in self._groups:
                g.load_ef_state(state.get(f"g{g.gid}", {}))
        else:
            # A flat checkpoint resumed under hier: the member tier owns
            # those residuals (the same sender identity).
            self._members.load_ef_state(state)


# ---------------------------------------------------------------------------
# Cross-process transport (the async trainer's hier mode)
# ---------------------------------------------------------------------------

class HierarchicalKVTransport:
    """KVGradientTransport's surface plus the two extra hops, each aware
    of its failure domain.

    Keys (one namespace a link, which is what ``link_jitter``'s prefix
    scoping keys on):

    - ``{run}/hgrad/{gid}/{sid}``   member -> group aggregator (fast link)
    - ``{run}/hagg/{gid}``          group aggregator -> root (slow link)
    - ``{run}/aparams``             root -> everyone (as the flat wire)

    The group aggregator's role is a group-scoped lease
    (``{run}/g{gid}/elect/...``): the preferred member claims it first;
    when its lease goes stale any surviving member campaigns and adopts
    the role. The pool does not migrate (it is transient; the new
    aggregator re-reads the member channels), so a failover costs at most
    one hop of staleness.
    """

    def __init__(self, kv, n_slices: int, grad_template: Any,
                 param_template: Any, run_id: str = "run",
                 plan: Optional[HierarchyPlan] = None, pid: int = 0,
                 group_size: int = 0, codec: str = "int8lat",
                 staleness_limit: int = 4, topk_frac: float = 0.01,
                 chan_codec: str = "blosc", level: int = 3,
                 bucket_bytes: int = 0, workers: int = 0,
                 hop_retries: int = 3, lease_interval_s: float = 1.0,
                 clock: Optional[Callable[[], float]] = None,
                 sleep: Optional[Callable[[float], None]] = None,
                 integrity: Any = None):
        self.kv = kv
        self.n = int(n_slices)
        self.plan = plan or HierarchyPlan(self.n, group_size)
        self.pid = int(pid)
        self.gid = self.plan.group_of(self.pid)
        self.run = run_id
        self.codec = codec
        self._chan_kw = dict(level=level, codec=chan_codec,
                             bucket_bytes=bucket_bytes, workers=workers)
        # My member up-link (written by me, read by my group's aggregator).
        self._my_chan = KVPytreeChannel(
            kv, f"{run_id}/hgrad/{self.gid}/{self.pid}", grad_template,
            **self._chan_kw)
        # The member channels the aggregator reads, built on adoption: a
        # member that never aggregates builds none.
        self._member_chans: Dict[int, KVPytreeChannel] = {}
        self._grad_template = grad_template
        # Up-link channels: mine (written while I hold the role) and, on
        # the root, every group's (read by poll_new_aggs).
        self._agg_chans: Dict[int, KVPytreeChannel] = {}
        self.param_ch = KVPytreeChannel(kv, f"{run_id}/aparams",
                                        param_template, **self._chan_kw)
        self._param_version = -1
        self._last_agg_seen: Dict[int, int] = {}
        # Tier-1 pooling runs wherever the role lands; the member-space
        # screen (when attached) rides in it, so a poisoned member is
        # rejected at its group hop, one hop from the source.
        self._pool = GroupAggregator(self.plan, self.gid, codec,
                                     staleness_limit=staleness_limit,
                                     topk_frac=topk_frac, hop_ef=False,
                                     integrity=integrity)
        self.election = group_election(
            kv, run_id, self.gid, self.pid, self.n,
            preferred=self.plan.aggregator_of(self.gid),
            interval_s=lease_interval_s, clock=clock, sleep=sleep)
        self._policy = RetryPolicy(max_attempts=max(1, int(hop_retries)),
                                   seed=1000 + self.gid)
        self._sleep = sleep
        self._adopted = False
        self._member_seen: Dict[int, int] = {}
        self._pub_version = 0       # local monotonic up-link version floor
        self.stats: Dict[str, int] = {
            "hops": 0, "group_publishes": 0, "failovers": 0,
            "hop_giveups": 0}

    # ---- role ----
    @property
    def is_aggregator(self) -> bool:
        return self.election.is_leader

    def _ensure_member_chans(self) -> Dict[int, KVPytreeChannel]:
        for sid in self.plan.members(self.gid):
            if sid not in self._member_chans:
                self._member_chans[sid] = KVPytreeChannel(
                    self.kv, f"{self.run}/hgrad/{self.gid}/{sid}",
                    self._grad_template, **self._chan_kw)
        return self._member_chans

    def _agg_chan(self, gid: int) -> KVPytreeChannel:
        ch = self._agg_chans.get(gid)
        if ch is None:
            ch = self._agg_chans[gid] = KVPytreeChannel(
                self.kv, f"{self.run}/hagg/{gid}", self._grad_template,
                **self._chan_kw)
        return ch

    def maintain_role(self) -> bool:
        """Refresh or campaign on the group lease; transient KV errors (a
        partition) read as "no change". Returns True when this call
        adopted the role by a failover (not the preferred member's first
        claim)."""
        try:
            if self.election.is_leader:
                try:
                    self.election.refresh()
                except Deposed:
                    self._adopted = False
                return False
            state = self.election.check()
            if state == "none" and \
                    self.pid == self.plan.aggregator_of(self.gid):
                self.election.claim_initial()
                self._adopted = True
                return False        # the initial claim, not a failover
            if state == "stale" and self.election.campaign():
                first = not self._adopted
                self._adopted = True
                if self.pid != self.plan.aggregator_of(self.gid) or \
                        not first:
                    self.stats["failovers"] += 1
                    return True
            return False
        except ElectionFailed:
            # Every campaign round failed: the KV is partitioned from this
            # side. Stay a member; the heal re-elects.
            return False
        except Exception as e:
            if not is_retryable(e):
                raise
            return False            # partitioned: keep the current belief

    # ---- member side ----
    def submit_grads(self, slice_id: int, seq: int, step: int,
                     grads: Any) -> None:
        """Member -> group hop. Transient failures are absorbed (a
        partitioned member trains on its last fetched parameters and
        publishes again next round)."""
        self._my_chan.try_publish(seq, grads, meta={"step": step})

    def fetch_params(self) -> Optional[Tuple[int, Any]]:
        got = self.param_ch.read()
        if got is None:
            return None
        version, tree, _ = got
        if version <= self._param_version:
            return None
        self._param_version = version
        return version, tree

    # ---- aggregator side ----
    def pump(self, current_step: int) -> int:
        """One maintenance round, run by EVERY process each loop: keep the
        group lease and, holding the role, drain the member channels into
        the group pool and publish the re-encoded aggregate up under the
        hop's jittered retry. Returns the number of upward publishes (0
        or 1)."""
        self.maintain_role()
        if not self.election.is_leader:
            return 0
        chans = self._ensure_member_chans()
        for sid, ch in chans.items():
            v = ch.latest_version()     # None on a transient error
            if v is None or v <= self._member_seen.get(sid, 0):
                continue
            got = ch.read(v)
            if got is None:
                continue
            version, tree, meta = got
            self._member_seen[sid] = version
            step = int((meta or {}).get("step", version))
            self._pool.submit_encoded(sid, step, tree)
        # A member that fetched newer canonical parameters than this
        # process stamps a step AHEAD of the local clock: the hop clock is
        # the newest step in sight, or the pool would drop it as negative
        # staleness.
        pend = self._pool.pending()
        if pend:
            current_step = max(current_step, max(pend.values()))
        out = self._pool.collect_and_reencode(current_step)
        if out is None:
            return 0
        step, wsum, tree = out
        ch = self._agg_chan(self.gid)
        # latest_version() is None both for "nothing published" and for a
        # transient read error, so the publish version cannot come from
        # the read alone: one hiccup would reset it to 1, the root's
        # high-water would ignore this group until it climbed back, and
        # the publish's GC of version-2 could delete live keys. A local
        # floor absorbs that; the observed version still counts, so a
        # failover adopter seeds past its predecessor once a read works.
        self._pub_version = max(self._pub_version,
                                ch.latest_version() or 0) + 1
        version = self._pub_version
        try:
            call_with_retry(
                ch.publish, version, tree,
                meta={"step": step, "wsum": wsum, "gid": self.gid},
                policy=self._policy, sleep=self._sleep)
        except Exception as e:
            if not is_retryable(e):
                raise
            # Retries spent inside a partition: the hop is skipped (its
            # pool already consumed). The root sees a silent subtree and
            # degrades; the heal publishes the next round.
            self.stats["hop_giveups"] += 1
            return 0
        self.stats["hops"] += 1
        self.stats["group_publishes"] += 1
        return 1

    # ---- root side ----
    def poll_new_aggs(self) -> List[Tuple[int, int, float, Any]]:
        """-> [(gid, step, wsum, payload tree)] newer than last seen, in
        gid order. Reads absorb transient errors (a partitioned up-link
        reads as silence, which is what degraded mode keys on)."""
        out = []
        for gid in range(self.plan.n_groups):
            ch = self._agg_chan(gid)
            v = ch.latest_version()
            if v is None or v <= self._last_agg_seen.get(gid, 0):
                continue
            got = ch.read(v)
            if got is None:
                continue
            version, tree, meta = got
            self._last_agg_seen[gid] = version
            meta = meta or {}
            out.append((gid, int(meta.get("step", version)),
                        float(meta.get("wsum", 1.0)), tree))
        return out

    def publish_params(self, version: int, params: Any) -> None:
        self.param_ch.publish(version, params)

    # ---- run lifecycle (KVGradientTransport's keys, absorbing transient
    #      errors: a partitioned follower must not crash polling) ----
    def set_done(self, final_step: int) -> None:
        self.kv.set(f"{self.run}/adone", str(int(final_step)))

    def done(self) -> Optional[int]:
        try:
            v = self.kv.get(f"{self.run}/adone")
        except Exception as e:
            if not is_retryable(e):
                raise
            return None
        return int(v) if v is not None else None

    def _channels(self) -> List[KVPytreeChannel]:
        return ([self._my_chan, self.param_ch]
                + list(self._member_chans.values())
                + list(self._agg_chans.values()))

    def close(self) -> None:
        """Stop the channels' worker threads, if any started."""
        for ch in self._channels():
            ch.close()

    def wire_stats(self) -> dict:
        chans = self._channels()
        return {
            "wire_bytes_out": sum(c.bytes_out for c in chans),
            "wire_bytes_in": sum(c.bytes_in for c in chans),
            "wire_bytes_raw_out": sum(c.bytes_raw_out for c in chans),
            "wire_publishes": sum(c.publishes for c in chans),
            "wire_read_errors": sum(c.read_errors for c in chans),
            "wire_publish_errors": sum(c.publish_errors for c in chans),
            "wire_integrity_failures": sum(c.integrity_failures
                                           for c in chans),
            "hier_hops": self.stats["hops"],
            "hier_failovers": self.stats["failovers"],
            "hier_hop_giveups": self.stats["hop_giveups"],
        }

    def describe(self) -> dict:
        d = self.plan.describe()
        d["pid"] = self.pid
        d["gid"] = self.gid
        d["is_aggregator"] = self.is_aggregator
        return d


def meta_json(d: dict) -> str:
    """Stable meta serialization for tests that pin hop metadata."""
    return json.dumps(d, sort_keys=True)
