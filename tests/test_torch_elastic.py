"""The port's elastic control plane against the JAX package, on the CPU.

- ``LeaderElection`` and ``MembershipRegistry`` of both packages driven by
  one script of operations on a ``ManualClock`` each: the two KV contents
  are equal, key by key and byte for byte, after every operation.
- The Coordinator's failover in process, in both packages: the same
  ``ELECTED`` / ``FOLLOW`` / ``DEPOSED`` lines in the same order.
- The JAX package's election, membership, failover, fault-kind, config,
  metric and checkpoint cases (``tests/test_elastic.py``), ported.
- One cross-process failover: three LeNet processes through the port's
  launcher, ``--mode async --elastic --elastic-leader 1``, the leader
  SIGKILLed by ``leader_kill``; asserted on the events (the kill, one
  election won by a survivor at a higher epoch, no deposition, one FINAL
  line on both survivors, the launcher letting the fleet finish), never
  on step counts or times.
"""

import dataclasses
import io
import json
import re
import signal
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest

from conftest import free_port
from ps_pytorch_tpu import config as jax_config
from ps_pytorch_tpu import elastic as jax_elastic
from ps_pytorch_tpu import resilience as jax_resilience
from ps_pytorch_tpu.runtime import coordinator as jax_coordinator
from ps_pytorch_tpu_torch import config, elastic, resilience
from ps_pytorch_tpu_torch.elastic import (
    Deposed, LeaderElection, MemberAnnouncer, MembershipRegistry, read_view,
)
from ps_pytorch_tpu_torch.resilience import (
    FaultInjector, ManualClock, TransientKVError, parse_fault_spec,
)
from ps_pytorch_tpu_torch.runtime import checkpoint as ckpt
from ps_pytorch_tpu_torch.runtime import coordinator
from ps_pytorch_tpu_torch.runtime.coordinator import (
    Coordinator, KVStore, LeaderLost,
)
from ps_pytorch_tpu_torch.tools import launch
from test_torch_train import two_torch_threads  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
PACKAGES = {
    "port": (elastic, resilience, coordinator),
    "jax": (jax_elastic, jax_resilience, jax_coordinator),
}


def _noop(_s):
    pass


def _election(kv, pid, n=3, clock=None, **kw):
    kw.setdefault("interval_s", 1.0)
    kw.setdefault("settle_s", 0.01)
    return LeaderElection(kv, "run", pid, n, clock=clock.time, sleep=_noop,
                          **kw)


# ---- the two packages under one script ----

def _script(pkg):
    """One script of election and membership operations over a package's
    KVStore and ManualClock; returns, after each operation, its name, its
    result (an exception as its class name and message) and the KV's
    whole contents."""
    el_mod, res_mod, co_mod = PACKAGES[pkg]
    clock, kv = res_mod.ManualClock(start=100.0), co_mod.KVStore()
    els = [el_mod.LeaderElection(kv, "run", p, 3, interval_s=1.0,
                                 settle_s=0.01, preferred=1,
                                 clock=clock.time, sleep=clock.sleep)
           for p in range(3)]
    anns = [el_mod.MemberAnnouncer(kv, "run", p, [p], interval_s=0.5,
                                   clock=clock.time) for p in range(3)]
    reg = el_mod.MembershipRegistry(kv, "run", 3, 3, timeout_s=3.0,
                                    clock=clock.time)
    ops = [
        ("check before any claim", lambda: els[0].check()),
        ("join 0", lambda: anns[0].join()),
        ("join 1", lambda: anns[1].join()),
        ("join 2", lambda: anns[2].join()),
        ("claim 1", lambda: els[1].claim_initial()),
        ("fold", lambda: reg.update(step=0)),
        ("refresh 1 throttled", lambda: els[1].refresh(1)),
        ("advance 1.5", lambda: clock.advance(1.5)),
        ("refresh 1", lambda: els[1].refresh(2)),
        ("check 0", lambda: els[0].check()),
        ("beat 0", lambda: anns[0].beat(3)),
        ("beat 2", lambda: anns[2].beat(3)),
        ("advance 5", lambda: clock.advance(5.0)),
        ("check 2 stale", lambda: els[2].check()),
        ("campaign 0", lambda: els[0].campaign()),
        ("campaign 2 follows", lambda: els[2].campaign()),
        ("refresh deposed 1", lambda: els[1].refresh(4)),
        ("beat 0 forced", lambda: anns[0].beat(5, force=True)),
        ("beat 2 forced", lambda: anns[2].beat(5, force=True)),
        ("fold evicts 1", lambda: reg.update(step=5)),
        ("leave 2", lambda: anns[2].leave()),
        ("fold leave", lambda: reg.update(step=6)),
        ("rejoin 1", lambda: anns[1].join()),
        ("fold rejoin", lambda: reg.update(step=7)),
        ("view", lambda: el_mod.read_view(kv, "run")),
        ("torn lease", lambda: kv.set("run/elect/lease", "{half")),
        ("campaign over garbage", lambda: els[2].campaign()),
        ("stats", lambda: [e.snapshot() for e in els]),
        ("registry", lambda: reg.snapshot()),
        ("events", lambda: [e.events for e in els] + [reg.events]),
    ]
    trace = []
    for name, op in ops:
        try:
            got = op()
        except Exception as e:          # Deposed differs in class only
            got = f"{type(e).__name__}: {e}"
        trace.append((name, got, dict(kv._d)))
    return trace


def test_election_and_membership_kv_bytes_equal_jax():
    ours, theirs = _script("port"), _script("jax")
    assert len(ours) == len(theirs)
    for (name, got, kv), (_, want, jkv) in zip(ours, theirs):
        assert got == want, name
        assert kv == jkv, name          # key by key, byte for byte
    names = dict((n, g) for n, g, _ in ours)
    assert names["campaign 0"] is True and names["campaign 2 follows"] is \
        False
    assert names["refresh deposed 1"].startswith("Deposed: process 1")
    assert names["fold evicts 1"]["members"] == [0, 2]


def _failover_lines(pkg):
    """Three Coordinators of a package over one KV, on a ManualClock. The
    leader (0) goes silent: follower 1 elects itself at step 2 and 0,
    back, is deposed. Then 1 goes silent: while follower 2 campaigns, 0
    claims the next epoch and publishes step 3's mask, and 2 follows it.
    Returns the printed lines, the masks and the stats."""
    el_mod, res_mod, co_mod = PACKAGES[pkg]
    clock, kv = res_mod.ManualClock(), co_mod.KVStore()
    cos = []
    for pid in range(3):
        el = el_mod.LeaderElection(kv, "run", pid, 3, interval_s=1.0,
                                   settle_s=0.01, preferred=0,
                                   clock=clock.time, sleep=_noop)
        cos.append(co_mod.Coordinator(3, mode="sync", kv=kv,
                                      leader=pid == 0,
                                      lease_interval_s=1.0,
                                      clock=clock.time, election=el))
    cos[0].election.claim_initial()

    def rival_claims(_s):
        cos[2].election.sleep = _noop
        cos[0].leader = cos[0].election.campaign()
        cos[0].participation_mask(3)

    out = io.StringIO()
    with redirect_stdout(out):
        cos[0].announce_step(1)
        masks = [c.participation_mask(1, timeout_s=5.0).tolist()
                 for c in cos]
        clock.now += 10.0
        masks += [cos[1].participation_mask(2, timeout_s=5.0).tolist(),
                  cos[2].participation_mask(2, timeout_s=5.0).tolist(),
                  cos[0].participation_mask(2, timeout_s=5.0).tolist()]
        clock.now += 10.0
        cos[2].election.sleep = rival_claims
        masks.append(cos[2].participation_mask(3, timeout_s=5.0).tolist())
    return (out.getvalue().splitlines(), masks, [c.stats for c in cos],
            [c.events for c in cos])


def test_coordinator_failover_lines_equal_jax():
    ours, theirs = _failover_lines("port"), _failover_lines("jax")
    assert ours == theirs
    lines = [ln for ln in ours[0] if not ln.startswith("MASK")]
    assert lines == ["ELECTED leader epoch 2 at step 2",
                     "DEPOSED at step 2: following leader 1 epoch 2",
                     "FOLLOW leader 0 epoch 3 at step 3"]
    assert ours[2][1]["elections"] == 1 and ours[2][0]["deposed"] == 1


# ---- election (tests/test_elastic.py, ported) ----

def test_election_bootstrap_claim_and_follow():
    clock, kv = ManualClock(), KVStore()
    leader = _election(kv, 1, preferred=1, clock=clock)
    follower = _election(kv, 0, preferred=1, clock=clock)
    assert leader.claim_initial() == 1
    assert leader.is_leader and leader.epoch == 1
    assert follower.check() == "fresh"
    assert (follower.epoch, follower.owner) == (1, 1)
    assert not follower.is_leader


def test_election_check_none_before_any_claim():
    clock, kv = ManualClock(start=50.0), KVStore()
    assert _election(kv, 0, clock=clock).check() == "none"


def test_election_stale_then_campaign_wins():
    clock, kv = ManualClock(), KVStore()
    leader = _election(kv, 1, preferred=1, clock=clock)
    leader.claim_initial()
    survivor = _election(kv, 0, preferred=1, clock=clock)
    assert survivor.check() == "fresh"
    clock.now += 10.0
    assert survivor.check() == "stale"
    assert survivor.campaign() is True
    assert survivor.is_leader and survivor.epoch == 2
    assert survivor.read_lease()[:2] == (2, 0)
    other = _election(kv, 2, preferred=1, clock=clock)
    assert other.check() == "fresh"
    assert (other.epoch, other.owner) == (2, 0)


def test_election_campaign_follows_fresh_lease():
    clock, kv = ManualClock(), KVStore()
    a = _election(kv, 0, clock=clock)
    a.claim_initial()
    b = _election(kv, 1, clock=clock)
    assert b.campaign() is False
    assert (b.epoch, b.owner) == (1, 0) and not b.is_leader


@pytest.mark.parametrize("me,other,preferred,winner", [
    (0, 2, 5, 0),       # preferred absent: the lowest pid
    (1, 0, 1, 1),       # preferred among the candidates: it wins
])
def test_election_tie_break(me, other, preferred, winner):
    clock, kv = ManualClock(), KVStore()
    c = _election(kv, me, preferred=preferred, clock=clock)
    kv.set(f"run/elect/cand/1/{other}", json.dumps([0.0]))
    assert c.campaign() is True
    assert c.epoch == 1 and c.read_lease()[1] == winner


def test_election_claim_race_read_back():
    clock, kv = ManualClock(), KVStore()
    c2 = _election(kv, 2, preferred=2, clock=clock)
    calls = []

    def racing_sleep(s):
        calls.append(s)
        if len(calls) == 2:     # the post-claim settle
            kv.set("run/elect/lease", json.dumps([1, 0, clock.time()]))

    c2.sleep = racing_sleep
    assert c2.campaign() is False
    assert (c2.epoch, c2.owner) == (1, 0) and not c2.is_leader


def test_election_deposed_fencing_on_refresh():
    clock, kv = ManualClock(), KVStore()
    old = _election(kv, 0, clock=clock)
    old.claim_initial()
    kv.set("run/elect/lease", json.dumps([2, 1, clock.time()]))
    with pytest.raises(Deposed, match="epoch 2 owner 1"):
        old.refresh(step=7)
    assert not old.is_leader and old.stats["deposed"] == 1
    assert (old.epoch, old.owner) == (2, 1)
    usurped = _election(kv, 3, clock=clock)
    usurped._claim(5)
    kv.set("run/elect/lease", json.dumps([5, 4, clock.time()]))
    with pytest.raises(Deposed):
        usurped.refresh()


def test_election_torn_lease_reads_as_absent():
    clock, kv = ManualClock(), KVStore()
    kv.set("run/elect/lease", "{half a json")
    el = _election(kv, 0, clock=clock)
    assert el.read_lease() is None
    assert el.check() == "none"
    assert el.campaign() is True


def test_election_fails_after_bounded_campaigns():
    """A winner that never claims (died between candidacy and claim):
    every round times out and ElectionFailed ends the campaign."""
    clock, kv = ManualClock(), KVStore()
    c = LeaderElection(kv, "run", 3, 4, interval_s=1.0, settle_s=0.5,
                       preferred=0, clock=clock.time, sleep=clock.sleep,
                       max_campaigns=2)
    for epoch in (1, 2):
        kv.set(f"run/elect/cand/{epoch}/0", json.dumps([0.0]))
    with pytest.raises(elastic.ElectionFailed, match="2 campaign rounds"):
        c.campaign()
    assert c.stats["campaigns"] == 2 and not c.is_leader


def test_group_election_namespaces_the_lease():
    clock, kv = ManualClock(), KVStore()
    g = elastic.group_election(kv, "run", 1, 3, 4, preferred=3,
                               clock=clock.time, sleep=_noop)
    g.claim_initial()
    assert json.loads(kv.get("run/g1/elect/lease"))[:2] == [1, 3]
    assert kv.get("run/elect/lease") is None


# ---- membership ----

def _membership(kv, clock, n=3, timeout_s=3.0):
    return MembershipRegistry(kv, "run", n, n, timeout_s=timeout_s,
                              clock=clock.time)


def test_membership_join_view_evict_readmit():
    clock, kv = ManualClock(), KVStore()
    reg = _membership(kv, clock)
    anns = [MemberAnnouncer(kv, "run", p, [p], interval_s=0.5,
                            clock=clock.time) for p in range(3)]
    for a in anns:
        a.join()
    view = reg.update(step=0)
    assert view["members"] == [0, 1, 2] and view["epoch"] == 1
    np.testing.assert_array_equal(reg.mask(), np.ones(3, np.float32))
    clock.now += 5.0
    for a in (anns[0], anns[2]):
        a.beat(step=1, force=True)
    view = reg.update(step=1)
    assert view["members"] == [0, 2] and view["epoch"] == 2
    np.testing.assert_array_equal(reg.mask(),
                                  np.array([1, 0, 1], np.float32))
    assert reg.counters["evictions"] == 1
    assert anns[1].join() >= 2
    view = reg.update(step=2)
    assert view["members"] == [0, 1, 2] and view["epoch"] == 3
    assert read_view(kv, "run")["epoch"] == 3


def test_membership_graceful_leave_counts_as_leave_not_eviction():
    clock, kv = ManualClock(), KVStore()
    reg = _membership(kv, clock)
    anns = [MemberAnnouncer(kv, "run", p, [p], clock=clock.time)
            for p in range(2)]
    for a in anns:
        a.join()
    reg.update(step=0)
    anns[1].leave()
    reg.update(step=1)
    assert reg.members == [0]
    assert reg.counters["leaves"] == 1 and reg.counters["evictions"] == 0


def test_membership_mask_all_ones_before_any_join():
    clock, kv = ManualClock(), KVStore()
    reg = _membership(kv, clock)
    reg.update(step=0)
    np.testing.assert_array_equal(reg.mask(), np.ones(3, np.float32))


def test_membership_evicted_is_dead_without_leaving():
    """The store server's exit wait skips exactly the processes the
    registry would evict: joined, beats stale. A process that left
    gracefully, or beats, is waited for."""
    clock, kv = ManualClock(), KVStore()
    reg = _membership(kv, clock)
    anns = [MemberAnnouncer(kv, "run", p, [p], clock=clock.time)
            for p in range(3)]
    for a in anns:
        a.join()
    assert reg.update(step=0)["members"] == [0, 1, 2]
    assert [reg.evicted(p) for p in range(3)] == [False] * 3
    clock.now += 5.0
    anns[0].beat(1, force=True)
    anns[2].leave()
    assert [reg.evicted(p) for p in range(3)] == [False, True, False]
    assert reg.update(step=1)["members"] == [0]
    assert reg.counters["evictions"] == 1 and reg.counters["leaves"] == 1


def test_membership_folds_into_the_mask():
    """The leader's mask is the membership view times liveness: an
    evicted process's replica is out of the very next mask."""
    clock, kv = ManualClock(), KVStore()
    reg = _membership(kv, clock, n=2)
    anns = [MemberAnnouncer(kv, "run", p, [p], clock=clock.time)
            for p in range(2)]
    for a in anns:
        a.join()
    co = Coordinator(2, mode="sync", kv=kv, membership=reg,
                     clock=clock.time)
    assert co.participation_mask(1).tolist() == [1, 1]
    clock.now += 5.0
    anns[0].beat(2, force=True)
    assert co.participation_mask(2).tolist() == [1, 0]


# ---- the Coordinator ----

def _elastic_coordinator(kv, clock, pid, leader, n=2):
    el = _election(kv, pid, n=n, preferred=0, clock=clock)
    return Coordinator(4, mode="sync", kv=kv, leader=leader,
                       lease_interval_s=1.0, clock=clock.time,
                       election=el), el


def test_coordinator_failover_elects_follower():
    clock, kv = ManualClock(), KVStore()
    c0, el0 = _elastic_coordinator(kv, clock, 0, True)
    c1, el1 = _elastic_coordinator(kv, clock, 1, False)
    el0.claim_initial()
    c0.announce_step(1)
    np.testing.assert_array_equal(c0.participation_mask(1),
                                  np.ones(4, np.float32))
    np.testing.assert_array_equal(c1.participation_mask(1, timeout_s=5.0),
                                  np.ones(4, np.float32))
    clock.now += 10.0
    mask = c1.participation_mask(2, timeout_s=5.0)
    np.testing.assert_array_equal(mask, np.ones(4, np.float32))
    assert c1.leader and el1.is_leader and el1.epoch == 2
    assert c1.stats["leader_lost"] == 1 and c1.stats["elections"] == 1
    assert any(e["event"] == "elected" for e in c1.events)
    np.testing.assert_array_equal(c0.participation_mask(2, timeout_s=5.0),
                                  np.ones(4, np.float32))
    assert not c0.leader and c0.stats["deposed"] == 1
    assert el0.epoch == 2 and el0.owner == 1


def test_coordinator_without_election_raises_leader_lost():
    clock, kv = ManualClock(), KVStore()
    leader = Coordinator(4, mode="sync", kv=kv, leader=True,
                         lease_interval_s=1.0, clock=clock.time)
    follower = Coordinator(4, mode="sync", kv=kv, leader=False,
                           lease_interval_s=1.0, clock=clock.time)
    leader.announce_step(1)
    leader.participation_mask(1)
    assert json.loads(kv.get("run/lease"))[0] == 1
    follower.participation_mask(1, timeout_s=5.0)
    clock.now += 10.0
    with pytest.raises(LeaderLost, match="stale"):
        follower.participation_mask(2, timeout_s=5.0)
    assert follower.stats["leader_lost"] == 1


def test_lease_keys_equal_jax():
    """The [step, ts] lease, the masks and the stats of a lease-only
    leader, byte for byte the JAX Coordinator's."""
    out = []
    for co_mod, res_mod in ((coordinator, resilience),
                            (jax_coordinator, jax_resilience)):
        clock, kv = res_mod.ManualClock(start=7.0), co_mod.KVStore()
        co = co_mod.Coordinator(3, mode="kofn", num_aggregate=2, kv=kv,
                                lease_interval_s=1.0, clock=clock.time)
        with redirect_stdout(io.StringIO()):
            for step in range(1, 5):
                co.report_duration(step % 3, step, 0.1 * step)
                co.participation_mask(step)
                clock.advance(0.6)
        out.append(dict(kv._d))
    assert out[0] == out[1]


# ---- fault kinds ----

def test_leader_kill_only_fires_on_leader_at_step():
    inj = FaultInjector("leader_kill:step=6", process_index=0)
    inj.maybe_kill_leader(5, is_leader=True)
    inj.maybe_kill_leader(9, is_leader=False)
    assert inj.snapshot()["leader_kills"] == 0


def test_leader_kill_sigkills_the_leader_process():
    code = ("from ps_pytorch_tpu_torch.resilience import FaultInjector; "
            "i = FaultInjector('leader_kill:step=3', process_index=0); "
            "i.maybe_kill_leader(3, is_leader=True); print('SURVIVED')")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60, cwd=str(REPO))
    assert res.returncode == -signal.SIGKILL
    assert "SURVIVED" not in res.stdout
    assert res.stdout.strip() == \
        "FAULT leader_kill: SIGKILL process 0 (leader) at step 3"


def test_kv_partition_drops_only_named_processes_in_window():
    spec = "kv_partition:r=1,step=5,steps=2"
    inside = FaultInjector(spec, process_index=1)
    kv = inside.wrap_kv(KVStore())
    kv.set("a", "1")
    inside.maybe_crash(5)
    with pytest.raises(TransientKVError, match="kv_partition"):
        kv.get("a")
    inside.maybe_crash(7)
    assert kv.get("a") == "1"
    outside = FaultInjector(spec, process_index=0)
    kv0 = outside.wrap_kv(KVStore())
    outside.maybe_crash(5)
    kv0.set("a", "1")
    assert kv0.get("a") == "1"


@pytest.mark.parametrize("spec", [
    "leader_kill:step=6", "leader_kill:p=0.5", "kv_partition:r=1",
    "kv_partition:r=1+2,step=5,steps=4", "kv_partition:r=1,step=2,steps=0"])
def test_fault_grammar_like_jax(spec):
    got = []
    for parse in (parse_fault_spec, jax_resilience.parse_fault_spec):
        try:
            got.append(parse(spec))
        except ValueError as e:
            got.append(str(e))
    assert got[0] == got[1]


# ---- config ----

@pytest.mark.parametrize("kw", [
    dict(elastic=True, leader_lease_s=1.0, elastic_leader=1),
    dict(leader_lease_s=2.0),
    dict(kv_replicas="dir:/a,dir:/b,http://127.0.0.1:1", kv_quorum=3,
         kv_resync_s=0.5),
    dict(fault_spec="leader_kill:step=3"),
    dict(fault_spec="kv_backend_kill:backend=1,step=2,steps=2;"
                    "kv_backend_wipe:backend=0,step=4",
         kv_replicas="mem:,mem:,mem:"),
    dict(elastic=True, leader_lease_s=1.0, heartbeat_interval_s=0.5,
         heartbeat_timeout_s=2.0),
])
@pytest.mark.parametrize("mode", ["sync", "kofn"])
def test_config_accepts_the_control_plane(kw, mode):
    extra = {"num_aggregate": 1} if mode == "kofn" else {}
    cfg = config.TrainConfig(eval_freq=0, mode=mode, **extra, **kw)
    for name, value in kw.items():
        assert getattr(cfg, name) == value


@pytest.mark.parametrize("kw", [
    dict(elastic=True), dict(elastic=True, leader_lease_s=1.0,
                             elastic_leader=-1),
    dict(leader_lease_s=-1.0), dict(kv_quorum=-1), dict(kv_resync_s=0.0),
    dict(kv_replicas="dir:/a,dir:/b,dir:/c", kv_quorum=1),
    dict(kv_replicas="dir:/a,dir:/b,dir:/c", kv_quorum=4),
    dict(kv_replicas="mem:,bogus-spec"),
    dict(heartbeat_timeout_s=1.0, leader_lease_s=2.0,
         heartbeat_interval_s=0.5),
])
def test_config_control_plane_errors_equal_jax(kw):
    msgs = []
    for cls in (config.TrainConfig, jax_config.TrainConfig):
        with pytest.raises(ValueError) as e:
            cls(eval_freq=0, **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_config_async_takes_the_control_plane_across_processes(
        monkeypatch):
    kw = dict(mode="async", eval_freq=0, elastic=True, leader_lease_s=2.0,
              elastic_leader=1, heartbeat_interval_s=1.0,
              kv_replicas="mem:,mem:,mem:",
              fault_spec="leader_kill:step=4;kv_drop:p=0.1;"
                         "kv_backend_wipe:backend=1,step=3;"
                         "replica_crash:r=2,step=9;ckpt_corrupt:step=6")
    with pytest.raises(ValueError, match="ROADMAP.md"):
        config.TrainConfig(**kw)            # one process: MultiSliceTrainer
    monkeypatch.setenv("PS_TPU_NUM_PROCESSES", "3")
    assert config.TrainConfig(**kw).elastic
    # grad_poison runs here since the integrity screen is ported; the LM's
    # expert fields are inert for the CNN trainers, as in the JAX package.
    assert config.TrainConfig(**dict(kw, fault_spec="grad_poison:scale=9"))
    for fine in (dict(lm_experts=2), dict(lm_moe_top_k=2)):
        assert dataclasses.asdict(config.TrainConfig(**dict(kw, **fine))) \
            == dataclasses.asdict(jax_config.TrainConfig(**dict(kw, **fine)))
    for bad, why in ((dict(fault_spec="grad_nan:step=3"), "mask"),
                     (dict(elastic=False), "--elastic"),
                     (dict(auto_resume=1), "sync or kofn")):
        with pytest.raises(ValueError, match=why):
            config.TrainConfig(**dict(kw, **bad))


# ---- telemetry and checkpoint ----

def test_elastic_metrics_declared_like_jax():
    from ps_pytorch_tpu.telemetry import registry as jax_telemetry
    from ps_pytorch_tpu_torch import telemetry
    from ps_pytorch_tpu_torch.telemetry.prometheus import render
    assert telemetry.ELASTIC_COUNTERS == jax_telemetry.ELASTIC_COUNTERS
    assert telemetry.ELASTIC_GAUGES == jax_telemetry.ELASTIC_GAUGES
    r = telemetry.declare_elastic_metrics(telemetry.Registry())
    r.inc("membership_changes")
    r.inc("elections")
    r.set("leader_epoch", 3.0)
    r.set("world_size", 2.0)
    text = render(r)
    assert "membership_changes_total 1" in text
    assert "leader_epoch 3" in text


def test_checkpoint_meta_carries_leader_epoch(tmp_path):
    state = {"params": {"w": np.ones(4, np.float32)}, "step": 3}
    ckpt.save_checkpoint(str(tmp_path), 3, state,
                         extra_meta={"leader_epoch": 2, "leader_pid": 1})
    got = ckpt.load_latest_valid(str(tmp_path))
    assert got is not None
    _, meta, _, _ = got
    assert meta == {"step": 3, "compressed": False, "leader_epoch": 2,
                    "leader_pid": 1}


# ---- three processes: the leader SIGKILLed, a survivor elected ----

_ARMED = r"""
import os, sys
from ps_pytorch_tpu_torch import train
argv = sys.argv[1:]
if os.environ["PS_TPU_PROCESS_ID"] == "1":    # the initial leader only
    argv += ["--fault-spec", "leader_kill:step=4"]
train.main(argv)
"""


def test_async_leader_kill_elects_a_survivor(tmp_path, monkeypatch):
    worker = tmp_path / "worker.py"
    worker.write_text(_ARMED)
    run_dir = tmp_path / "run"
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = io.StringIO()
    try:
        with redirect_stdout(out):
            rc = launch.main([
                "launch", "--run-dir", str(run_dir), "--simulate", "3",
                "--port", str(free_port()), "--entry", str(worker),
                "--wait", "--timeout", "150", "--grace", "1", "--",
                "--device", "cpu", "--mode", "async", "--network", "LeNet",
                "--dataset", "synthetic_mnist", "--batch-size", "32",
                "--compute-dtype", "float32", "--max-steps", "16",
                "--eval-freq", "2", "--staleness-limit", "8",
                "--resume", "false", "--train-dir", str(tmp_path / "td"),
                "--elastic", "--elastic-leader", "1",
                "--leader-lease-s", "1.5"])
    finally:
        launch.main(["kill", "--run-dir", str(run_dir), "--grace", "1"])
    logs = [(run_dir / f"proc_{r}.log").read_text() for r in range(3)]
    detail = "\n\n".join(log[-2000:] for log in logs)
    # The launcher let the survivors finish: one log lacks FINAL, so the
    # wait reports 1, but it never killed the fleet.
    assert rc == 1 and "killing fleet" not in out.getvalue(), detail
    last = logs[1].strip().splitlines()[-1]
    assert re.fullmatch(r"FAULT leader_kill: SIGKILL process 1 \(leader\) "
                        r"at step \d+", last), detail
    elected = [(r, m) for r in (0, 2) for m in re.findall(
        r"^ELECTED async leader process (\d+) epoch (\d+) at version "
        r"\d+ \(election \S+s\)$", logs[r], re.M)]
    assert len(elected) == 1, detail
    winner, (pid, epoch) = elected[0][0], elected[0][1]
    assert int(pid) == winner and int(epoch) >= 2
    assert not any("DEPOSED" in log for log in logs)
    finals = [re.findall(r"^FINAL .*$", logs[r], re.M) for r in (0, 2)]
    assert all(len(f) == 1 for f in finals) and finals[0] == finals[1]
    # The new leader committed the last checkpoint under its epoch.
    last_step = ckpt.committed_steps(str(tmp_path / "td"))[-1]
    meta = json.loads((Path(ckpt.checkpoint_path(
        str(tmp_path / "td"), last_step)) / "meta.json").read_text())
    assert (meta["leader_epoch"], meta["leader_pid"]) == (int(epoch),
                                                        winner)
    assert re.search(rf"^ELASTIC pid {winner} epoch {epoch} .* wins 1$",
                     logs[winner], re.M)
