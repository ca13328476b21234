"""The port's chaos drills (``ps_pytorch_tpu_torch/tools/``: elastic,
poison, kvrep and router) against the JAX package's, on the CPU.

- Each drill's parsers, fed the lines its workers print (the port's FAULT,
  ELECTED, ELASTIC, REBALANCE, MEMBERSHIP, INTEGRITY, DRILLSTATS,
  KVREPSTATS and FINAL lines) and the load generator's stats, build an
  artifact that the JAX ``tools/regress.compare`` accepts for the
  ``elastic``, ``integrity``, ``kvrep`` and ``router`` families. The
  integrity and kvrep gates also read a bench row (the overhead budget,
  from the port's ``bench_suite``): given one, the artifact passes;
  without one, the overhead budget is the only check it fails.
- The in-process bitwise phases (``poison_drill._phase_bitwise``,
  ``kvrep_drill._phase_bitwise``) report ``bitwise_equal`` true and the
  JAX phases' counters; the bench phases, at a small size, give the JAX
  phases' row keys (their ``ok`` is a timing, not asserted here).
- Marked ``slow`` (each a minute or more of several processes): every
  drill's multi-process phases end to end with ``--device cpu`` at its
  defaults.
"""

import argparse
import json

import pytest

from ps_pytorch_tpu.tools import kvrep_drill as jax_kvrep_drill
from ps_pytorch_tpu.tools import poison_drill as jax_poison_drill
from ps_pytorch_tpu.tools import regress
from ps_pytorch_tpu_torch.tools import (
    elastic_drill, kvrep_drill, poison_drill, router_drill,
)
from test_torch_train import two_torch_threads  # noqa: F401


def _failing(report) -> set:
    return {name for name, c in
            report["configs"]["invariants"]["metrics"].items()
            if not c["ok"]}


# ---------------------------------------------------------------- elastic --

FAILOVER_LOGS = [
    "ASYNC process-slices 3 x 1 devices\n"
    "ELECTED async leader process 0 epoch 2 at version 5 (election "
    "0.105s)\nELASTIC pid 0 epoch 2 world 2 membership_changes 1 wins 1\n"
    "FINAL loss 2.350001 prec1 0.1059 prec5 0.5947\n",
    "ASYNC process-slices 3 x 1 devices\n"
    "FAULT leader_kill: SIGKILL process 1 (leader) at step 2\n",
    "ELASTIC pid 2 epoch 2 world 0 membership_changes 0 wins 0\n"
    "FINAL loss 2.350001 prec1 0.1059 prec5 0.5947\n",
]
MEMBERSHIP = {"membership_changes": 3, "joins": 4, "leaves": 1,
              "evictions": 0, "epoch": 3, "world_size": 3}
REBALANCE_LOGS = [
    (f"MEMBERSHIP {json.dumps(MEMBERSHIP)}\n" if p == 0 else "")
    + f'REBALANCE pid {p} bitwise_equal true {{"rebalances": 2}}\n'
    "FINAL rebalance ok\n" for p in range(3)]


def _elastic_args(**kw):
    return argparse.Namespace(**dict(dict(
        device="cpu", grad_codec="", ef=False, max_steps=48, kill_step=2),
        **kw))


def test_elastic_artifact_passes_the_jax_gate():
    failover = elastic_drill.parse_failover(FAILOVER_LOGS, 1)
    rebalance = elastic_drill.parse_rebalance(REBALANCE_LOGS, 0)
    assert failover["ok"] and rebalance["ok"]
    assert failover["new_leader_pid"] == 0 and failover["final_epoch"] == 2
    art = elastic_drill.build_artifact(_elastic_args(), failover, rebalance)
    assert art["elastic"]["membership_changes"] == 4
    assert art["elastic"]["rebalances"] == 2
    report = regress.compare("elastic", None, art)
    assert report["ok"], report
    # A drill where nobody died proves nothing: the gate refuses it.
    calm = elastic_drill.parse_failover(
        [FAILOVER_LOGS[0], "", FAILOVER_LOGS[2]], 0)
    assert not calm["ok"]
    art = elastic_drill.build_artifact(_elastic_args(), calm, rebalance)
    assert not regress.compare("elastic", None, art)["ok"]


def test_elastic_worker_flags():
    args = _elastic_args(train_dir="/tmp/td", grad_codec="int8lat", ef=True)
    armed = elastic_drill.failover_args(args, True)
    assert armed[armed.index("--fault-spec") + 1] == "leader_kill:step=2"
    calm = elastic_drill.failover_args(args, False)
    assert calm[calm.index("--fault-spec") + 1] == ""
    assert calm[calm.index("--grad-codec") + 1] == "int8lat"
    assert calm[calm.index("--elastic-leader") + 1] == "1"


# ----------------------------------------------------------------- poison --

def _poison_logs(quarantine=True):
    stats = [{"payload_bitflips": 17, "grad_poisons": 0},
             {"payload_bitflips": 0, "grad_poisons": 0},
             {"payload_bitflips": 0, "grad_poisons": 16},
             {"payload_bitflips": 0, "grad_poisons": 0}]
    logs = [f"FINAL loss 2.337449 prec1 0.1020 prec5 0.4276\n"
            f"DRILLSTATS pid {p} {json.dumps(stats[p])}\n" for p in range(4)]
    if quarantine:
        logs[0] = ("INTEGRITY quarantine contributor 2 at version 5 (leaf "
                   "0: int8lat exponent 116 out of bounds (|e| > 64))\n"
                   "INTEGRITY readmit contributor 2 at version 16\n"
                   "INTEGRITY pid 0 screen_rejects 11 outlier_rejects 0 "
                   "strikes 11 quarantines 1 readmissions 1 wire_failures "
                   "17\n") + logs[0]
    return logs


def _finals(loss):
    return [f"FINAL loss {loss} prec1 0.1 prec5 0.5\n" for _ in range(4)]


def _poison_args():
    return argparse.Namespace(device="cpu", max_steps=40, poison_step=3,
                              poison_steps=16, ef_clip=1.0)


def test_poison_artifact_passes_the_jax_gate():
    clean = poison_drill.parse_clean(_finals("2.299987"), 0)
    poison = poison_drill.parse_poison(_poison_logs(), 0, 2.299987)
    poison_ef = poison_drill.parse_poison_ef(_poison_logs(), 0)
    control = poison_drill.parse_control(_finals("nan"), 0, 2.299987)
    assert all(p["ok"] for p in (clean, poison, poison_ef, control))
    assert poison["quarantined_at_version"] == 5
    assert poison["readmitted_at_version"] == 16
    bitwise = poison_drill._phase_bitwise()
    bench = {"ok": True, "baseline_s": 0.01, "integrity_s": 0.01005,
             "overhead_frac": 0.005}
    art = poison_drill.build_artifact(_poison_args(), clean, poison,
                                      poison_ef, control, bitwise, bench)
    report = regress.compare("integrity", None, art)
    assert report["ok"], report
    # Without the bench row the overhead budget is the one check that
    # fails.
    art = poison_drill.build_artifact(_poison_args(), clean, poison,
                                      poison_ef, control, bitwise)
    assert not art["ok"] and "overhead_frac" not in art["integrity"]
    assert _failing(regress.compare("integrity", None, art)) == \
        {"ok", "overhead_frac"}
    # No quarantine, or a control that did not diverge, fails the phase.
    assert not poison_drill.parse_poison(_poison_logs(False), 0,
                                         2.299987)["ok"]
    assert not poison_drill.parse_control(_finals("2.31"), 0, 2.3)["ok"]


def _smaller(monkeypatch, module, name, steps, **kw):
    """``module.name`` called with ``steps`` and ``kw`` over its caller's
    arguments."""
    full = getattr(module, name)
    monkeypatch.setattr(module, name, lambda row, _steps, **k: full(
        row, steps, **{**k, **kw}))


def test_poison_bitwise_phase_is_the_jax_phase(monkeypatch):
    got, want = poison_drill._phase_bitwise(), jax_poison_drill._phase_bitwise()
    assert got["ok"] and got["bitwise_equal"]
    for key in ("counters", "events", "rejected_rounds", "total_steps"):
        assert got[key] == want[key], key
    # The bench phase: the integrity-overhead row, LeNet at batch 16.
    import bench_suite as jax_suite
    from ps_pytorch_tpu_torch import bench_suite
    _smaller(monkeypatch, bench_suite, "bench_integrity_overhead", 2,
             batch=16, reps=1)
    row = poison_drill._phase_bench("cpu")
    want = jax_suite.bench_integrity_overhead("poison_drill_bench", 2,
                                              batch=16, reps=1)
    assert set(row) == set(want) | {"device_kind"}
    assert (row["config"], row["steps"], row["platform"]) == \
        ("poison_drill_bench", 2, "cpu")
    assert row["wire_chunks"] == want["wire_chunks"]
    assert row["baseline_s"] > 0 and row["integrity_s"] > 0


# ------------------------------------------------------------------ kvrep --

def _kvrep_logs():
    stats = {"kvrep_rejoins": 1, "kvrep_resyncs": 1, "kvrep_ejections": 1,
             "kvrep_backends_healthy": 3, "kv_giveups": 0, "version": 24}
    return [f"FINAL loss 2.3 prec1 0.1 prec5 0.5\n"
            f"KVREPSTATS pid {p} {json.dumps(stats)}\n" for p in range(3)]


LOAD = {"availability": 1.0, "failed_5xx": 0, "requests": 60,
        "completed": 60, "status_counts": {"200": 60},
        "latency_p99_ms": 80.0}


def test_kvrep_artifact_passes_the_jax_gate():
    evidence = {"killed": True, "wiped": True, "kill_at_s": 1.5}
    train = kvrep_drill.parse_train(_kvrep_logs(), 0, evidence, True, 144,
                                    False, 24)
    assert train["ok"] and train["rejoins"] == 3 and train["max_version"] == 24
    serve = kvrep_drill.serve_section(LOAD, 60, 3, 6, 6, 2)
    bitwise = kvrep_drill._phase_bitwise()
    assert serve["ok"] and bitwise["ok"]
    args = argparse.Namespace(device="cpu")
    overhead = {"ok": True, "overhead_frac": 0.01, "budget": 0.05}
    art = kvrep_drill.build_artifact(args, train, serve, bitwise, overhead)
    report = regress.compare("kvrep", None, art)
    assert report["ok"], report
    art = kvrep_drill.build_artifact(args, train, serve, bitwise)
    assert not art["ok"]
    assert _failing(regress.compare("kvrep", None, art)) == \
        {"ok", "overhead_frac"}
    # A give-up, or a run short of its versions, fails the phase.
    logs = [t.replace('"kv_giveups": 0', '"kv_giveups": 1')
            for t in _kvrep_logs()]
    assert not kvrep_drill.parse_train(logs, 0, evidence, True, 144, False,
                                       24)["ok"]
    assert not kvrep_drill.parse_train(_kvrep_logs(), 0, evidence, True,
                                       144, False, 30)["ok"]
    assert not kvrep_drill.serve_section(dict(LOAD, failed_5xx=1), 60, 3,
                                         6, 6, 0)["ok"]


def test_kvrep_bitwise_phase_is_the_jax_phase(monkeypatch):
    got, want = kvrep_drill._phase_bitwise(), jax_kvrep_drill._phase_bitwise()
    assert got["ok"] and got["bitwise_equal"]
    assert got == want
    # The overhead phase at 2 MB, both packages.
    import bench_suite as jax_suite
    from ps_pytorch_tpu_torch import bench_suite
    for module in (bench_suite, jax_suite):
        _smaller(monkeypatch, module, "bench_kvrep_overhead", 1,
                 payload_mb=2, leaf_kb=256, reps=1)
    got, want = kvrep_drill._phase_overhead(), \
        jax_kvrep_drill._phase_overhead()
    assert set(got) == set(want)
    assert {k: got[k] for k in ("payload_mb", "rtt_ms", "n_backends",
                                "budget")} == \
        {k: want[k] for k in ("payload_mb", "rtt_ms", "n_backends",
                              "budget")} == \
        {"payload_mb": 2, "rtt_ms": 2.0, "n_backends": 3, "budget": 0.05}


# ----------------------------------------------------------------- router --

def test_router_artifact_passes_the_jax_gate():
    kill = router_drill.kill_section(LOAD, True, 2, -9, 1)
    roll = [{"id": i, "ok": True, "model_step": 2} for i in range(3)]
    reload_ = router_drill.reload_section(LOAD, roll, {0: 2, 1: 2, 2: 2}, 3)
    counters = {"hedges": 8, "hedge_wins": 5, "hedge_cancelled": 3,
                "retries": 1, "failed": 0}
    hedge = router_drill.hedge_section(
        dict(LOAD, latency_p99_ms=368.6), dict(LOAD, latency_p99_ms=173.5),
        8, counters, 0.15)
    assert kill["ok"] and reload_["ok"] and hedge["ok"]
    assert hedge["p99_ratio"] == round(173.5 / 368.6, 4)
    art = router_drill.finish_artifact(
        router_drill.new_artifact("cpu", 3), True, kill, reload_, hedge,
        counters, 1)
    assert art["ok"] and art["counters"]["router_hedges"] == 8
    assert regress.compare("router", None, art)["ok"]
    # A fleet that did not advance, or hedging that lost, fails the gate.
    stale = router_drill.reload_section(LOAD, roll, {0: 2, 1: 1, 2: 2}, 3)
    lost = router_drill.hedge_section(dict(LOAD, latency_p99_ms=100.0),
                                      dict(LOAD, latency_p99_ms=120.0), 4,
                                      counters, 0.15)
    art = router_drill.finish_artifact(
        router_drill.new_artifact("cpu", 3), True, kill, stale, lost,
        counters, 1)
    assert _failing(regress.compare("router", None, art)) == \
        {"ok", "model_step_advanced", "hedge_p99_ratio"}


# ------------------------------------------------- artifacts and devices --

@pytest.mark.parametrize("mod,name", [
    (elastic_drill, "RESILIENCE_r11.json"),
    (poison_drill, "RESILIENCE_r16.json"),
    (kvrep_drill, "RESILIENCE_r17.json"),
    (router_drill, "RESILIENCE_r15.json")])
def test_drills_refuse_jax_artifacts_and_a_missing_card(mod, name,
                                                        tmp_path):
    assert mod.ARTIFACT_NOT_WRITTEN == name
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(["--run-dir", str(tmp_path)])
    if mod is not router_drill:     # router refuses before its run dir
        with pytest.raises(ValueError, match="JAX drill's artifact"):
            mod.main(["--device", "cpu", "--run-dir", str(tmp_path),
                      "--out", str(tmp_path / name)])


# ------------------------------------------- multi-process, end to end --

def _artifact(tmp_path):
    return json.loads((tmp_path / "a.json").read_text())


@pytest.mark.slow
def test_elastic_drill_runs_on_the_cpu(tmp_path):
    assert elastic_drill.main(["--device", "cpu", "--run-dir",
                               str(tmp_path), "--out",
                               str(tmp_path / "a.json")]) == 0
    assert regress.compare("elastic", None, _artifact(tmp_path))["ok"]


@pytest.mark.slow
def test_poison_drill_runs_on_the_cpu(tmp_path):
    rc = poison_drill.main(["--device", "cpu", "--run-dir", str(tmp_path),
                            "--out", str(tmp_path / "a.json")])
    art = _artifact(tmp_path)
    assert rc == (0 if art["ok"] else 1)
    assert "overhead_frac" in art["integrity"]
    # The bench's budget is a timing: the one check that may fail here.
    assert _failing(regress.compare("integrity", None, art)) <= \
        {"ok", "overhead_frac"}


@pytest.mark.slow
def test_kvrep_drill_runs_on_the_cpu(tmp_path):
    rc = kvrep_drill.main(["--device", "cpu", "--run-dir", str(tmp_path),
                           "--out", str(tmp_path / "a.json")])
    art = _artifact(tmp_path)
    assert rc == (0 if art["ok"] else 1)
    assert "overhead_frac" in art["kvrep"]["overhead"]
    assert _failing(regress.compare("kvrep", None, art)) <= \
        {"ok", "overhead_frac"}


@pytest.mark.slow
def test_router_drill_runs_on_the_cpu(tmp_path):
    assert router_drill.main(["--device", "cpu", "--run-dir", str(tmp_path),
                              "--out", str(tmp_path / "a.json")]) == 0
    assert regress.compare("router", None, _artifact(tmp_path))["ok"]
