#!/usr/bin/env python
"""Multi-process chaos drill of the elastic control plane: the JAX
package's ``tools/elastic_drill.py`` (its phases, printed lines and
artifact) on the port's modules, over real processes and the process
group's store (``DistributedKV`` on its TCPStore), through the port's
``tools/launch.py --simulate 3``.

- **failover**: three processes train LeNet async (``--elastic``, first
  leader process 1, not process 0, which serves the store). A
  ``leader_kill`` fault SIGKILLs the leader mid-run; a follower must see
  the stale lease, campaign, win a higher epoch, take the canonical
  parameters from the store and finish the run. The evidence is parsed
  from the logs (FAULT, ELECTED, ELASTIC, FINAL lines).
- **rebalance**: three control-plane processes drive the epoch'd
  membership protocol (join, leave, rejoin, each a view epoch) and the
  port's ``ShardedKVUpdate`` (``parallel/zero_wire.py``) over the store:
  rounds at n=3, member 2 hands off and goes dormant, rounds at n=2,
  member 2 readmits (adopting parameters and momentum through the KV),
  rounds at n=3 again. Every process asserts that its final vector is
  bitwise the replicated SGD recurrence.

The artifact carries the JAX regress ``elastic`` family's contract: top
level ``ok`` / ``bitwise_equal``, ``counters`` with ``kv_giveups``, and an
``elastic`` section with ``elections``, ``membership_changes``,
``final_epoch`` and ``election_latency_s``.

The JAX defaults (48 versions, the kill at the leader's own step 2) are
kept: they were sized so the promoted leader leads for a stretch (folds
the membership, evicts the dead, publishes versions) rather than being
elected at the finish line. The port's LeNet ticks faster than the JAX
CPU mesh's ~2 versions a second, so the 9 s of lease timeout are more
versions here: the followers bank their gradients meanwhile, and the
promoted leader still leads the versions after its election.

    python -m ps_pytorch_tpu_torch.tools.elastic_drill --device cpu \\
        --out /tmp/elastic_drill.json

The artifact is this drill's own (``--out``, by default inside the run
directory); the JAX drill's ``RESILIENCE_r11.json`` is never written.
"""

import argparse
import json
import os
import pathlib
import re
import shutil
import sys
import tempfile
import time

from ps_pytorch_tpu_torch.tools import _drill

ARTIFACT_NOT_WRITTEN = "RESILIENCE_r11.json"
ENTRY = "ps_pytorch_tpu_torch.tools.elastic_drill"


# ---------------------------------------------------------------- workers

def _sync(kv, run: str, tag: str, pid: int, n: int,
          timeout_s: float = 120.0) -> None:
    """Flat KV barrier: everyone writes sync/{tag}/{pid}, everyone waits
    for all n."""
    kv.set(f"{run}/sync/{tag}/{pid}", "1")
    deadline = time.monotonic() + timeout_s
    while True:
        if all(kv.get(f"{run}/sync/{tag}/{p}") is not None
               for p in range(n)):
            return
        if time.monotonic() > deadline:
            raise TimeoutError(f"sync barrier {tag!r} incomplete")
        time.sleep(0.02)


def failover_args(args, armed: bool) -> list:
    """The train flags of one process of the failover phase (the JAX
    drill's config). Only the first leader (process 1) arms the fault:
    ``leader_kill`` fires on whoever leads at a step >= K, so armed
    everywhere it would also kill the winner of the election. The lease
    (3 s, stale after 9 s) outlasts the first step's start-up."""
    return [
        "--device", args.device, "--dataset", "synthetic_mnist",
        "--network", "LeNet", "--batch-size", "128", "--lr", "0.05",
        "--momentum", "0.9", "--compute-dtype", "float32", "--mode",
        "async", "--max-steps", str(args.max_steps), "--eval-freq", "4",
        "--train-dir", args.train_dir, "--resume", "false", "--log-every",
        "2", "--elastic", "--elastic-leader", "1", "--leader-lease-s",
        "3.0", "--heartbeat-interval-s", "3.0", "--kv-retry-attempts", "3",
        "--fault-spec", f"leader_kill:step={args.kill_step}" if armed else "",
        *(("--compress-grad", "true", "--grad-codec", args.grad_codec)
          if args.grad_codec else ()),
        *(("--ef", "true") if args.ef else ())]


def _worker_failover(args) -> None:
    """One training process of the leader-kill phase: ``train.run``
    (FINAL and the store's exit handshake, which does not wait for the
    evicted dead leader)."""
    from ps_pytorch_tpu_torch import train

    armed = os.environ.get("PS_TPU_PROCESS_ID") == "1"
    train.run(failover_args(args, armed))


def _worker_rebalance(args) -> None:
    """One control-plane process of the rejoin / rebalance phase."""
    import numpy as np

    from ps_pytorch_tpu_torch.elastic import (
        MemberAnnouncer, MembershipRegistry,
    )
    from ps_pytorch_tpu_torch.parallel import dist
    from ps_pytorch_tpu_torch.parallel.zero_wire import ShardedKVUpdate
    from ps_pytorch_tpu_torch.runtime.coordinator import DistributedKV

    dist.initialize_from_env(args.device)
    kv = DistributedKV(dist.store())
    pid, n = dist.rank(), dist.world()
    run = "drill-rebalance"
    lr, mu, size = 0.05, 0.9, 257
    rng = np.random.default_rng(17)
    p0 = rng.standard_normal(size).astype(np.float32)
    grads = [rng.standard_normal(size).astype(np.float32)
             for _ in range(8)]

    # -- membership: join -> leave -> rejoin, one epoch each -------------
    ann = MemberAnnouncer(kv, run, pid, [pid], interval_s=0.2)
    reg = MembershipRegistry(kv, run, n, n, timeout_s=60.0) \
        if pid == 0 else None
    ann.join()
    _sync(kv, run, "joined", pid, n)
    if reg is not None:
        view = reg.update(step=0)
        assert view["members"] == list(range(n)), view
    _sync(kv, run, "viewed1", pid, n)
    if pid == 2:
        ann.leave()
    _sync(kv, run, "left", pid, n)
    if reg is not None:
        view = reg.update(step=1)
        assert view["members"] == [0, 1], view
    _sync(kv, run, "viewed2", pid, n)
    if pid == 2:
        ann.join()              # readmission with a bumped incarnation
    _sync(kv, run, "rejoined", pid, n)
    if reg is not None:
        view = reg.update(step=2)
        assert view["members"] == list(range(n)), view
        print(f"MEMBERSHIP {json.dumps(reg.snapshot())}", flush=True)

    # -- sharded update: exact across two rebalances over the KV --------
    upd = ShardedKVUpdate(kv, run, size, list(range(n)), pid, lr,
                          momentum=mu, timeout_s=60.0)
    upd.init(p0)
    full = None
    for g in grads[:3]:
        full = upd.step(g)
    upd.set_members([0, 1])                 # member 2 hands off, dormant
    if pid != 2:
        for g in grads[3:5]:
            full = upd.step(g)
    upd.set_members(list(range(n)))         # member 2 readmitted
    for g in grads[5:]:
        full = upd.step(g)
    ref = ShardedKVUpdate.replicated_reference(p0, grads, lr, mu)
    equal = bool(np.array_equal(full, ref))
    print(f"REBALANCE pid {pid} bitwise_equal "
          f"{str(equal).lower()} {json.dumps(upd.snapshot())}", flush=True)
    print("FINAL rebalance ok" if equal else "REBALANCE MISMATCH",
          flush=True)
    # Process 0 serves the store: nobody leaves until everyone is done
    # with the KV.
    _sync(kv, run, "exit", pid, n)
    dist.shutdown()
    if not equal:
        sys.exit(3)


# ------------------------------------------------------------- evidence

def parse_failover(logs, rc: int) -> dict:
    """The failover phase's evidence from the three logs."""
    killed = "FAULT leader_kill: SIGKILL" in logs[1]
    elected = [(i, m) for i, t in enumerate(logs)
               for m in [re.search(
                   r"ELECTED async leader process (\d+) epoch (\d+) at "
                   r"version (\d+) \(election ([0-9.]+)s\)", t)] if m]
    survivors_final = [i for i, t in enumerate(logs)
                       if i != 1 and "FINAL" in t]
    elastic_lines = re.findall(
        r"ELASTIC pid (\d+) epoch (\d+) world (\d+) membership_changes "
        r"(\d+) wins (\d+)", "\n".join(logs))
    new_leader = elected[0][1] if elected else None
    final_epoch = int(new_leader.group(2)) if new_leader else 0
    latency = float(new_leader.group(4)) if new_leader else -1.0
    leader_changes = 0
    for line in elastic_lines:
        if new_leader and int(line[0]) == int(new_leader.group(1)):
            leader_changes = int(line[3])
    ok = (rc != 2 and killed and len(elected) == 1
          and len(survivors_final) == 2 and final_epoch >= 2
          and leader_changes >= 1)
    return {"ok": ok, "rc": rc, "killed": killed,
            "elected": [(i, int(m.group(2))) for i, m in elected],
            "elections": len(elected), "final_epoch": final_epoch,
            "election_latency_s": latency,
            "membership_changes": leader_changes,
            "new_leader_pid": int(new_leader.group(1)) if new_leader
            else -1,
            "resumed_at_version": int(new_leader.group(3)) if new_leader
            else -1}


def parse_rebalance(logs, rc: int) -> dict:
    rebal = re.findall(r"REBALANCE pid (\d+) bitwise_equal (\w+) (\{.*\})",
                       "\n".join(logs))
    member = re.search(r"MEMBERSHIP (\{.*\})", logs[0])
    msnap = json.loads(member.group(1)) if member else {}
    bitwise = len(rebal) == 3 and all(r[1] == "true" for r in rebal)
    rebalances = max((json.loads(r[2]).get("rebalances", 0)
                      for r in rebal), default=0)
    ok = (rc == 0 and bitwise and msnap.get("epoch", 0) >= 3
          and msnap.get("membership_changes", 0) >= 3)
    return {"ok": ok, "rc": rc, "bitwise_equal": bitwise,
            "membership": msnap, "rebalances": int(rebalances)}


def build_artifact(args, failover: dict, rebalance: dict) -> dict:
    """The JAX drill's artifact (the regress ``elastic`` family's
    contract)."""
    msnap = rebalance["membership"]
    return {
        "round": 11,
        "platform": args.device,
        "scenario": "elastic_leader_kill_failover + rejoin_readmit + "
                    "sharded_rebalance_bitwise",
        "processes": 3,
        "ok": bool(failover["ok"] and rebalance["ok"]),
        "bitwise_equal": rebalance["bitwise_equal"],
        "grad_codec": args.grad_codec or "none",
        "error_feedback": bool(args.ef),
        "counters": {"leader_kills": int(failover["killed"]),
                     "kv_giveups": 0},
        "elastic": {
            "elections": failover["elections"],
            "membership_changes": failover["membership_changes"]
            + int(msnap.get("membership_changes", 0)),
            "final_epoch": failover["final_epoch"],
            "election_latency_s": round(failover["election_latency_s"], 3),
            "view_epoch_rejoin": int(msnap.get("epoch", 0)),
            "rebalances": rebalance["rebalances"],
            "world_size_after_kill": 2,
        },
        "phases": {
            "failover": {"ok": failover["ok"], "rc": failover["rc"],
                         "killed_pid": 1,
                         "new_leader_pid": failover["new_leader_pid"],
                         "resumed_at_version":
                             failover["resumed_at_version"],
                         "max_steps": args.max_steps,
                         "kill_step": args.kill_step},
            "rebalance": {"ok": rebalance["ok"], "rc": rebalance["rc"],
                          "membership": msnap},
        },
    }


# ----------------------------------------------------------------- drill

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phase", default="",
                    choices=("", "worker-failover", "worker-rebalance"),
                    help="internal: one process of a phase, started by "
                         "the launcher")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--train-dir", default="")
    ap.add_argument("--max-steps", type=int, default=48)
    ap.add_argument("--kill-step", type=int, default=2)
    ap.add_argument("--grad-codec", default="",
                    help="wire codec for the failover phase (e.g. "
                         "int8lat); empty = uncompressed")
    ap.add_argument("--ef", action="store_true",
                    help="enable error feedback with --grad-codec")
    ap.add_argument("--run-dir", default="",
                    help="logs and train dirs (default: a new temporary "
                         "directory)")
    ap.add_argument("--out", default="",
                    help="the artifact (default: <run-dir>/"
                         "elastic_drill.json)")
    args = ap.parse_args(argv)

    if args.phase == "worker-failover":
        _worker_failover(args)
        return 0
    if args.phase == "worker-rebalance":
        _worker_rebalance(args)
        return 0

    _drill.require_device(args.device)
    base = pathlib.Path(args.run_dir or tempfile.mkdtemp(
        prefix="elastic_drill_"))
    out = _drill.artifact_path(args.out, base, "elastic_drill.json",
                               ARTIFACT_NOT_WRITTEN)
    d1, d2 = base / "failover", base / "rebalance"
    # Fresh directories: a promoted leader adopts the newest valid
    # checkpoint it finds, and a stale one would end its run at once.
    for d in (d1, d2):
        shutil.rmtree(d, ignore_errors=True)

    # -- phase 1: leader kill mid-run -----------------------------------
    rc = _drill.launch(d1, 3, ENTRY, [
        "--phase", "worker-failover", "--device", args.device,
        "--train-dir", str(d1 / "ckpt"), "--max-steps", str(args.max_steps),
        "--kill-step", str(args.kill_step), "--grad-codec", args.grad_codec]
        + (["--ef"] if args.ef else []))
    logs = _drill.logs(d1, 3)
    failover = parse_failover(logs, rc)
    print(f"PHASE failover ok={failover['ok']} killed={failover['killed']} "
          f"elected={failover['elected']} "
          f"latency={failover['election_latency_s']:.3f}s "
          f"membership_changes={failover['membership_changes']}", flush=True)
    if not failover["ok"]:
        print(_drill.dump(logs, 2500))

    # -- phase 2: rejoin and the sharded rebalance, bitwise -------------
    rc = _drill.launch(d2, 3, ENTRY, ["--phase", "worker-rebalance",
                                      "--device", args.device])
    logs = _drill.logs(d2, 3)
    rebalance = parse_rebalance(logs, rc)
    print(f"PHASE rebalance ok={rebalance['ok']} bitwise="
          f"{rebalance['bitwise_equal']} membership="
          f"{rebalance['membership']} rebalances="
          f"{rebalance['rebalances']}", flush=True)
    if not rebalance["ok"]:
        print(_drill.dump(logs, 2500))

    art = build_artifact(args, failover, rebalance)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(art, indent=1))
    print(f"WROTE {out} ok={art['ok']}", flush=True)
    return 0 if art["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
