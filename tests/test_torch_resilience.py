"""The port's crash containment (``ps_pytorch_tpu_torch/resilience``, the
sync Trainer's hooks and ``train --auto-resume``) against the JAX
package's ``resilience/`` on the CPU, the cases of
``tests/test_resilience.py`` this slice covers:

- the fault-spec grammar: the same faults parsed, the same specs rejected
  with the same message; the kinds no trainer of the port runs refused by
  the config, naming ROADMAP.md;
- FaultyKV's seeded drop, delay and op-filter decisions, equal to the JAX
  injector's (``default_rng(seed + 10007 * pid)``);
- the coordinator under 5% drops for 50 steps: the leader's drops, retries
  and backoff sleeps equal to the JAX leader's, and a leader and a
  follower in two threads with no error and no give-up;
- heartbeat eviction, readmission, the throttle and never masking
  everyone, each mask equal to the JAX coordinator's on one ManualClock;
- the trainer: a crash auto-resumed ends bitwise where an uninterrupted
  run does (through ``train.main --auto-resume`` too), a run resumes past
  a corrupt newest checkpoint (one the JAX trainer corrupted), a
  ``ckpt_corrupt`` fault, keep-N, the SIGTERM emergency checkpoint, a
  ``grad_nan`` fault, and the resilience JSONL columns and ``/metrics``
  counters under the JAX package's names.
"""

import io
import json
import os
import threading
import urllib.request
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from conftest import free_port
from ps_pytorch_tpu import resilience as jax_res
from ps_pytorch_tpu.config import TrainConfig as JaxConfig
from ps_pytorch_tpu.runtime.coordinator import (
    Coordinator as JaxCoordinator, KVStore as JaxKV,
)
from ps_pytorch_tpu.runtime.trainer import Trainer as JaxTrainer
from ps_pytorch_tpu.telemetry.registry import (
    RESILIENCE_COUNTERS as JAX_RESILIENCE_COUNTERS,
)
from ps_pytorch_tpu_torch import resilience, train
from ps_pytorch_tpu_torch.config import TrainConfig
from ps_pytorch_tpu_torch.resilience import (
    FaultInjector, Heartbeat, InjectedCrash, LivenessMonitor, ManualClock,
    TransientKVError, corrupt_file, parse_fault_spec, run_with_auto_resume,
)
from ps_pytorch_tpu_torch.runtime import checkpoint as ckpt
from ps_pytorch_tpu_torch.runtime.coordinator import Coordinator, KVStore
from ps_pytorch_tpu_torch.runtime.trainer import Trainer
from ps_pytorch_tpu_torch.telemetry import parse_exposition

ACCEPTED = [
    "kv_drop:p=0.05,seed=7;replica_crash:r=2,step=40;"
    "ckpt_corrupt:step=20,mode=truncate",
    "kv_delay:p=0.1,s=0.02,seed=3,op=get", "grad_nan:step=30,r=1",
    "kv_partition:r=1+2,step=5,steps=4",
    "kv_partition:group=1,gsize=2,step=5,steps=4",
    "link_jitter:s=0.02,prefix=async-0/hagg,p=0.5,seed=3",
    "payload_bitflip:p=0.05,seed=9,prefix=async-42/agrad",
    "payload_truncate:p=0.02,seed=4", "leader_kill:step=6",
    "replica_kill:served=20,r=0", "grad_poison:scale=1000,r=2",
    "kv_backend_kill:backend=1,step=5", "kv_backend_wipe:backend=1,step=8",
    "",
]
REJECTED = [
    "typo_kind:p=0.1", "kv_drop:p=1.5", "kv_drop:p", "kv_drop:p=0.1,op=rename",
    "kv_delay:p=0.1", "replica_crash:r=1", "ckpt_corrupt:step=5,mode=eat",
    "kv_partition:r=1,group=1,step=2", "link_jitter:p=0.5",
    "grad_poison:r=2", "grad_poison:scale=1e38,r=2,step=-1",
    "kv_backend_kill:backend=0", "replica_kill:r=0",
]


# ---- the grammar ----

@pytest.mark.parametrize("spec", ACCEPTED)
def test_fault_spec_parses_like_jax(spec):
    assert parse_fault_spec(spec) == jax_res.parse_fault_spec(spec)


@pytest.mark.parametrize("spec", REJECTED)
def test_fault_spec_rejects_like_jax(spec):
    msgs = []
    for parse in (parse_fault_spec, jax_res.parse_fault_spec):
        with pytest.raises(ValueError) as e:
            parse(spec)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("spec,refused", [
    ("leader_kill:step=6", False), ("kv_backend_kill:backend=1,step=5", False),
    ("kv_backend_wipe:backend=1,step=8", False),
    ("replica_kill:served=20", False), ("grad_poison:scale=1000,r=2", True)])
def test_config_refuses_the_kinds_it_does_not_run(spec, refused):
    """leader_kill and the per-backend kinds run since the elections and
    the replicated KV are ported, and serving's replica_kill since serving
    is (the trainers pass it by, as the JAX ones do); grad_poison is still
    refused under the synchronous trainer (the default mode here): only
    the async leader's integrity screen runs it."""
    JaxConfig(fault_spec=spec)                  # the JAX config runs them
    if refused:
        with pytest.raises(ValueError, match="ROADMAP.md"):
            TrainConfig(fault_spec=spec)
    else:
        assert TrainConfig(fault_spec=spec).fault_spec == spec


def test_config_refuses_faults_and_heartbeats_in_async():
    for kw in (dict(fault_spec="kv_drop:p=0.1"),
               dict(heartbeat_interval_s=1.0), dict(auto_resume=1)):
        with pytest.raises(ValueError, match="ROADMAP.md"):
            TrainConfig(mode="async", **kw)


@pytest.mark.parametrize("kw", [
    dict(fault_spec="kv_drop:p=2.0"), dict(heartbeat_interval_s=-1.0),
    dict(heartbeat_interval_s=1.0, heartbeat_timeout_s=0.5),
    dict(auto_resume=-1), dict(loader_workers=-2)])
def test_config_validates_like_jax(kw):
    msgs = []
    for cls in (TrainConfig, JaxConfig):
        with pytest.raises(ValueError) as e:
            cls(**kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# ---- FaultyKV: seeded decisions ----

def _pattern(make_injector, make_kv, seed, pid, n=200, p=0.25):
    inj = make_injector(f"kv_drop:p={p},seed={seed}", process_index=pid)
    kv = inj.wrap_kv(make_kv())
    out = []
    for i in range(n):
        try:
            kv.set(f"k{i}", "v")
            out.append(0)
        except ConnectionError:             # TransientKVError in both
            out.append(1)
    return out, inj.snapshot()["kv_drops"]


@pytest.mark.parametrize("seed,pid", [(7, 0), (8, 0), (7, 1)])
def test_faulty_kv_drops_like_jax(seed, pid):
    ours = _pattern(FaultInjector, KVStore, seed, pid)
    theirs = _pattern(jax_res.FaultInjector, JaxKV, seed, pid)
    assert ours == theirs and ours[1] > 0


def test_faulty_kv_delay_and_op_filter_like_jax():
    sleeps = []
    for inj_cls, kv_cls, clock_cls in (
            (FaultInjector, KVStore, ManualClock),
            (jax_res.FaultInjector, JaxKV, jax_res.ManualClock)):
        clock = clock_cls()
        inj = inj_cls("kv_delay:p=0.5,s=0.25,seed=1;"
                      "kv_drop:p=1.0,seed=0,op=set", process_index=0,
                      clock=clock.time, sleep=clock.sleep)
        inner = kv_cls()
        kv = inj.wrap_kv(inner)
        for i in range(20):
            with pytest.raises(ConnectionError):
                kv.set(f"k{i}", "v")            # a dropped set writes nothing
            assert kv.get(f"k{i}") is None and inner.get(f"k{i}") is None
        sleeps.append((clock.sleeps, inj.snapshot()))
    assert sleeps[0] == sleeps[1]
    assert sleeps[0][1]["kv_drops"] == 20 and sleeps[0][1]["kv_delays"] > 0


# ---- the coordinator under chaos ----

class _Cfg:
    fault_spec = "kv_drop:p=0.05,seed=7"
    kv_retry_attempts = 8
    kv_retry_base_s = 0.001
    kv_retry_budget = 10000
    seed = 0


def test_leader_chaos_5pct_drops_50_steps_like_jax():
    got = []
    for mod, coord_cls, kv_cls, clock_cls in (
            (resilience, Coordinator, KVStore, ManualClock),
            (jax_res, JaxCoordinator, JaxKV, jax_res.ManualClock)):
        clock = clock_cls()
        inj = mod.FaultInjector(_Cfg.fault_spec, process_index=0,
                                sleep=clock.sleep)
        kv, _, retrier = mod.wrap_kv_with(kv_cls(), _Cfg, inj,
                                          sleep=clock.sleep)
        leader = coord_cls(4, mode="sync", kv=kv, leader=True)
        masks = []
        for s in range(1, 51):
            leader.announce_step(s)
            masks.append(leader.participation_mask(s).tolist())
        got.append((masks, clock.sleeps, inj.snapshot()["kv_drops"],
                    retrier.snapshot()))
    assert got[0] == got[1]
    assert got[0][2] > 0 and got[0][3]["kv_retries"] == got[0][2]
    assert got[0][3]["kv_giveups"] == 0


def test_coordinator_chaos_leader_and_follower_threads():
    base = KVStore()
    kv_l, _, retr_l = resilience.wrap_kv_with(
        base, _Cfg, FaultInjector(_Cfg.fault_spec, process_index=0))
    kv_f, _, retr_f = resilience.wrap_kv_with(
        base, _Cfg, FaultInjector(_Cfg.fault_spec, process_index=1))
    leader = Coordinator(4, mode="sync", kv=kv_l, leader=True)
    follower = Coordinator(4, mode="sync", kv=kv_f, leader=False)
    errs = []

    def follow():
        try:
            for s in range(1, 51):
                follower.wait_for_step(after=s - 1, timeout_s=30.0)
                assert follower.participation_mask(
                    s, timeout_s=30.0).shape == (4,)
        except Exception as e:  # noqa: BLE001 - surfaced through errs
            errs.append(e)

    th = threading.Thread(target=follow)
    th.start()
    for s in range(1, 51):
        leader.announce_step(s)
        leader.participation_mask(s)
    th.join(60)
    assert not th.is_alive() and errs == []
    assert retr_l.snapshot()["kv_retries"] + \
        retr_f.snapshot()["kv_retries"] > 0
    assert retr_l.snapshot()["kv_giveups"] == 0
    assert retr_f.snapshot()["kv_giveups"] == 0


# ---- heartbeats ----

def _liveness_script(mod, coord_cls, kv_cls):
    """The JAX tests' heartbeat scenarios on one ManualClock: the masks,
    the monitors' counters and events."""
    out = {}
    clock = mod.ManualClock()
    kv = kv_cls()
    hbs = [mod.Heartbeat(kv, "run", [r], interval_s=1.0, clock=clock.time)
           for r in range(4)]
    mon = mod.LivenessMonitor(kv, "run", 4, timeout_s=3.0, clock=clock.time)
    c = coord_cls(4, mode="sync", kv=kv, run_id="run", leader=True,
                  liveness=mon)
    out["boot"] = c.participation_mask(0).tolist()     # never beaten: alive
    for hb in hbs:
        hb.beat(1)
    out["all"] = c.participation_mask(1).tolist()
    clock.advance(4.0)
    for hb in hbs[:3]:
        hb.beat(2)
    out["evicted"] = c.participation_mask(2).tolist()
    out["throttled"] = hbs[0].beat(2)
    hbs[3].beat(3)
    out["readmitted"] = c.participation_mask(3).tolist()
    out["counters"] = mon.snapshot()
    out["events"] = [e["event"] for e in mon.events]
    kv.set("run/hb/0", "not json")           # a torn beat: a missed beat
    clock.advance(10.0)                      # everyone looks dead
    out["nobody"] = c.participation_mask(4).tolist()
    return out


def test_heartbeat_liveness_like_jax():
    ours = _liveness_script(resilience, Coordinator, KVStore)
    theirs = _liveness_script(jax_res, JaxCoordinator, JaxKV)
    assert ours == theirs
    assert ours["evicted"] == [1, 1, 1, 0] and ours["readmitted"] == [1] * 4
    assert ours["counters"] == {"evictions": 1, "readmissions": 1}
    assert ours["nobody"] == [1] * 4            # never masks everyone
    assert ours["throttled"] is False


# ---- the trainer ----

def _cfg(tmp_path, **kw):
    base = dict(dataset="synthetic_mnist", network="LeNet", batch_size=64,
                lr=0.01, momentum=0.9, max_steps=6, epochs=0, eval_freq=2,
                train_dir=str(tmp_path / "ckpt"), compute_dtype="float32",
                log_every=2, seed=3)
    base.update(kw)
    return TrainConfig(**base)


def _params(trainer):
    return {k: v.detach().clone() for k, v in
            trainer.model.state_dict().items()}


def test_crash_auto_resume_is_bitwise_the_uninterrupted_run(tmp_path):
    plain = Trainer(_cfg(tmp_path / "plain"), device="cpu")
    plain.train()
    cfg = _cfg(tmp_path / "chaos", fault_spec="replica_crash:r=0,step=4")
    injector = FaultInjector(cfg.fault_spec, process_index=0)
    built = []

    def make():
        built.append(Trainer(cfg, device="cpu", injector=injector))
        return built[-1]

    run_with_auto_resume(make, max_restarts=2)
    assert injector.snapshot()["crashes"] == 1 and len(built) == 2
    assert built[1].start_step == 2
    assert ckpt.latest_valid_step(cfg.train_dir) == cfg.max_steps
    want, got = _params(plain), _params(built[-1])
    for k in want:
        assert torch.equal(want[k], got[k]), k


def test_cli_auto_resume_walks_past_a_corrupt_checkpoint(tmp_path):
    """train.main --auto-resume: the crash at step 5 resumes from 4; the
    ckpt_corrupt fault then breaks step 6's commit, so a later run with
    more steps walks past it to 4 and ends bitwise where an uninterrupted
    run ends; the JSONL's retries equal its drops."""
    flags = ["--device", "cpu", "--network", "LeNet", "--dataset",
             "synthetic_mnist", "--batch-size", "32", "--compute-dtype",
             "float32", "--momentum", "0.9", "--eval-freq", "2",
             "--ckpt-keep", "3", "--test-batch-size", "1000"]
    chaos = str(tmp_path / "chaos")
    out = io.StringIO()
    with redirect_stdout(out):
        train.main([*flags, "--max-steps", "6", "--train-dir", chaos,
                    "--auto-resume", "2", "--metrics-file",
                    f"{chaos}.jsonl", "--heartbeat-interval-s", "0.01",
                    "--fault-spec",
                    "replica_crash:r=0,step=5;ckpt_corrupt:step=6;"
                    "kv_drop:p=0.2,seed=7"])
        resumed, _ = train.run([*flags, "--max-steps", "8", "--train-dir",
                                chaos])
        plain, _ = train.run([*flags, "--max-steps", "8", "--train-dir",
                              str(tmp_path / "plain")])
    text = out.getvalue()
    assert "CRASH InjectedCrash: injected replica_crash r=0 at step 5" in text
    assert f"RESUME from {chaos}/model_step_4 at step 4" in text
    assert "[ckpt] step 6 failed verification" in text
    assert text.count("RESUME") == 2
    want, got = _params(plain), _params(resumed)
    for k in want:
        assert torch.equal(want[k], got[k]), k
    rows = [json.loads(line) for line in open(f"{chaos}.jsonl")]
    # One retry plane a trainer (as in the JAX package), one injector
    # across the rebuild (its crash count tells the trainers apart): each
    # trainer's last row has its own retries.
    runs = list({r["crashes"]: r for r in rows}.values())
    assert [r["crashes"] for r in runs] == [0, 1]
    assert sum(r["kv_retries"] for r in runs) == runs[-1]["kv_drops"] > 0
    assert runs[-1]["kv_giveups"] == 0


def test_resumes_past_the_jax_trainers_corrupt_newest(tmp_path):
    """The JAX trainer's ckpt_corrupt fault strikes its step-6 commit: the
    port's trainer walks past it to the JAX package's step 4, as the JAX
    trainer does."""
    kw = dict(dataset="synthetic_mnist", network="LeNet", batch_size=64,
              lr=0.01, momentum=0.9, max_steps=6, epochs=0, eval_freq=2,
              train_dir=str(tmp_path / "ckpt"), compute_dtype="float32",
              data_axis=1, log_every=2, seed=3)
    injector = jax_res.FaultInjector("ckpt_corrupt:step=6", process_index=0)
    JaxTrainer(JaxConfig(**kw, fault_spec="ckpt_corrupt:step=6"),
               injector=injector).train()
    assert injector.snapshot()["ckpt_corruptions"] == 1
    assert ckpt.committed_steps(kw["train_dir"]) == [2, 4, 6]
    assert ckpt.latest_valid_step(kw["train_dir"]) == 4
    kw.pop("data_axis")
    assert Trainer(TrainConfig(**kw), device="cpu").start_step == 4


def test_ckpt_corrupt_fault_keep_n_and_shared_injector(tmp_path):
    cfg = _cfg(tmp_path, fault_spec="ckpt_corrupt:step=6", ckpt_keep=2)
    injector = FaultInjector(cfg.fault_spec, process_index=0)
    Trainer(cfg, device="cpu", injector=injector).train()
    assert injector.snapshot()["ckpt_corruptions"] == 1
    assert ckpt.committed_steps(cfg.train_dir) == [4, 6]
    assert ckpt.latest_valid_step(cfg.train_dir) == 4
    again = Trainer(cfg, device="cpu", injector=injector)   # no refire
    assert again.start_step == 4
    corrupt_file(os.path.join(ckpt.checkpoint_path(cfg.train_dir, 4),
                              "state.msgpack"))
    assert Trainer(cfg, device="cpu").start_step == 0


def test_sigterm_writes_the_emergency_checkpoint(tmp_path, capsys):
    cfg = _cfg(tmp_path, eval_freq=0)           # no periodic checkpoints
    t = Trainer(cfg, device="cpu")
    t._preempt.trigger()                        # SIGTERM already pending
    t.train()
    assert "PREEMPT emergency checkpoint at step 1" in capsys.readouterr().out
    assert ckpt.latest_valid_step(cfg.train_dir) == 1


def test_grad_nan_fault_leaves_the_parameters(tmp_path, capsys):
    cfg = _cfg(tmp_path, fault_spec="grad_nan:step=2", eval_freq=0,
               max_steps=2, log_every=1, metrics_file=str(tmp_path / "m"))
    t = Trainer(cfg, device="cpu")
    t.train()
    assert "FAULT grad_nan: poisoned mask at step 2" in \
        capsys.readouterr().out
    rows = [json.loads(line) for line in open(tmp_path / "m")]
    assert np.isnan(rows[1]["loss"]) and rows[1]["grad_nans"] == 1
    assert all(torch.isfinite(p).all() for p in t.model.parameters())


def test_resilience_columns_and_metrics_like_jax(tmp_path):
    """The JSONL carries the resilience counters under the JAX names when
    a fault plane or heartbeats are on (and not otherwise); /metrics
    serves every counter the JAX registry declares."""
    plain = _cfg(tmp_path / "p", eval_freq=0, max_steps=2, log_every=1,
                 metrics_file=str(tmp_path / "plain.jsonl"))
    Trainer(plain, device="cpu").train()
    row = json.loads(open(tmp_path / "plain.jsonl").readline())
    assert "kv_drops" not in row and "evictions" not in row
    cfg = _cfg(tmp_path, fault_spec="kv_drop:p=0.25,seed=11",
               kv_retry_attempts=6, metrics_port=free_port(), eval_freq=0,
               max_steps=2, log_every=1, heartbeat_interval_s=0.5,
               metrics_file=str(tmp_path / "m.jsonl"))
    t = Trainer(cfg, device="cpu")
    try:
        for i in range(40):                 # through the fault + retry shims
            try:
                t.coordinator.kv.set(f"probe/{i}", "x")
            except TransientKVError:
                pass
        url = f"http://127.0.0.1:{cfg.metrics_port}/metrics"
        with urllib.request.urlopen(url, timeout=10) as resp:
            samples = parse_exposition(resp.read().decode())
    finally:
        t.ops.exporter.stop()
    names = {name for name, _, _ in JAX_RESILIENCE_COUNTERS}
    assert {f"{n}_total" for n in names} <= set(samples)
    assert samples["kv_drops_total"] > 0 and samples["kv_retries_total"] > 0
    # The JAX trainer's resilience_stats keys (no elections, no kvrep).
    want = set(jax_res.FaultInjector("", 0).snapshot()) | {
        "kv_retries", "kv_giveups", "evictions", "readmissions",
        "mask_changes"}
    assert set(t.resilience_stats()) == want


def test_injected_crash_is_raised_once(tmp_path):
    cfg = _cfg(tmp_path, fault_spec="replica_crash:r=0,step=3",
               eval_freq=0)
    injector = FaultInjector(cfg.fault_spec, process_index=0)
    with pytest.raises(InjectedCrash):
        Trainer(cfg, device="cpu", injector=injector).train()
    Trainer(cfg, device="cpu", injector=injector).train()   # no refire
    assert injector.snapshot()["crashes"] == 1


def test_heartbeat_monitor_runs_in_the_trainer(tmp_path):
    cfg = _cfg(tmp_path, heartbeat_interval_s=0.5, eval_freq=0,
               max_steps=2, log_every=1,
               metrics_file=str(tmp_path / "m.jsonl"))
    t = Trainer(cfg, device="cpu")
    t.train()
    assert isinstance(t.heartbeat, Heartbeat)
    assert isinstance(t.coordinator.liveness, LivenessMonitor)
    rows = [json.loads(line) for line in open(tmp_path / "m.jsonl")]
    assert rows[-1]["evictions"] == 0 and rows[-1]["mask_changes"] == 0
