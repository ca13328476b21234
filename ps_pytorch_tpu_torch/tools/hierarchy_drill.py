#!/usr/bin/env python
"""Subtree-partition drill of the hierarchical sync: the JAX package's
``tools/hierarchy_drill.py``, its ``partition`` and ``bitwise`` phases.

- **partition** (four processes): LeNet trained async with
  ``--sync-topology hier`` (2 groups of 2, int8lat + EF) over the process
  group's store, through the port's ``tools/launch.py --simulate 4``. A
  ``kv_partition:group=1,...`` window, armed on every process, cuts group 1
  (processes 2, 3) off the KV mid-run, keyed on their own steps. The root
  must declare the subtree partitioned (``HIER partition group 1``), keep
  applying updates from group 0, re-graft the healed subtree (``HIER
  regraft group 1``) and finish; all four processes print FINAL. The
  evidence is parsed from the logs (HIER, HIERARCHY, DRILLSTATS, FINAL).
- **bitwise** (in one process, deterministic): the same arc through
  ``HierarchicalAggregator`` driving a seeded SGD recurrence, checkpointed
  after the re-graft (the parameters and the members' and hops' EF
  residuals); the rerun from the checkpoint must end bitwise where the
  uninterrupted run ends.

- **bench** (in one process): the hier-against-flat latency row of the
  port's ``bench_suite.bench_hier_agg`` at the JAX drill's scale (2 MB
  payload, 4 slices in groups of 2, one rep): the regress ``hierarchy``
  family's ``speedup > 1`` travels in the artifact's ``hierarchy.bench``.

    python -m ps_pytorch_tpu_torch.tools.hierarchy_drill --device cpu \\
        --out /tmp/hier_drill.json

The artifact is this drill's own (``--out``; by default inside the run
directory); the JAX drill's ``RESILIENCE_r14.json`` is never written.

The window is counted in the partitioned processes' own steps, the
partition in leader versions (more than ``staleness_limit`` of silence),
so it is sized from the ratio of the two. The JAX drill cuts 12 of 40
steps; the port's LeNet leader ticks ~3x faster than a partitioned
follower steps on the CPU (~0.08 s against ~0.25 s, each KV op failing
twice), so those 12 steps outlast the whole run and the regraft never
comes. The defaults here cut 6 steps (~18 versions, well past the limit
of 4) from own step 6, and run 60 versions, which leaves ~30 after the
heal for the regraft. Where a follower takes several steps a leader tick
(ResNet-18 on the card), the window must span at least ``staleness_limit
+ 2`` versions of its steps instead.
"""

import argparse
import hashlib
import json
import pathlib
import re
import shutil
import sys
import tempfile
from typing import Callable, Optional

import numpy as np

from ps_pytorch_tpu_torch.tools import _drill

ARTIFACT_NOT_WRITTEN = "RESILIENCE_r14.json"
ENTRY = "ps_pytorch_tpu_torch.tools.hierarchy_drill"


# ---------------------------------------------------------------- workers

def worker_args(args) -> list:
    """The train flags of one process of the partition phase (the JAX
    drill's config): retries kept low so a partitioned step degrades in
    ~100 ms, and a 3 s group lease that clears the first step's build."""
    return [
        "--device", args.device, "--dataset", "synthetic_mnist",
        "--network", "LeNet", "--batch-size", "64", "--lr", "0.05",
        "--momentum", "0.9", "--compute-dtype", "float32", "--mode",
        "async", "--max-steps", str(args.max_steps), "--eval-freq", "0",
        "--train-dir", args.train_dir, "--resume", "false", "--log-every",
        "4", "--compress-grad", "true", "--grad-codec", "int8lat", "--ef",
        "true", "--sync-topology", "hier", "--sync-group-size", "2",
        "--staleness-limit", "4", "--leader-lease-s", "3.0",
        "--kv-retry-attempts", "2", "--fault-spec",
        f"kv_partition:group=1,gsize=2,step={args.cut_step},"
        f"steps={args.cut_steps}"]


def _worker_partition(args) -> None:
    """One process of the partition phase: ``train.run`` (FINAL and the
    store's exit handshake included), then one DRILLSTATS line."""
    from ps_pytorch_tpu_torch import train

    trainer, _ = train.run(worker_args(args))
    stats = dict(trainer.transport.stats)
    if trainer.injector is not None:
        stats.update(trainer.injector.snapshot())
    if trainer._retrier is not None:
        stats.update(trainer._retrier.snapshot())
    print(f"DRILLSTATS pid {trainer.pid} {json.dumps(stats)}", flush=True)


# ----------------------------------------------------- in-process phases

def _lenet_free_grad(i: int, t: int) -> dict:
    rng = np.random.default_rng(1000 + 97 * i + t)
    return {"w": rng.standard_normal(513).astype(np.float32)}


def _phase_bitwise(resume_step: int = 20, total_steps: int = 32,
                   grad: Optional[Callable[[int, int], dict]] = None,
                   params0: Optional[dict] = None,
                   agg_cls=None) -> dict:
    """The deterministic partition arc and the bit-for-bit resume through
    an in-process ``HierarchicalAggregator`` (``agg_cls``, the port's by
    default): group 1's members are silent for steps 8-14, the root
    degrades then re-grafts, and a checkpoint after the re-graft (the
    parameters and the EF residuals) replays to the same final bits as
    the uninterrupted run. ``grad(i, t)`` gives member i's gradient tree
    at step t (by default the JAX drill's seeded 513-vector; its leaves
    may be tensors on a card), ``params0`` the start (by default the JAX
    drill's)."""
    if agg_cls is None:
        from ps_pytorch_tpu_torch.parallel.hierarchy import (
            HierarchicalAggregator as agg_cls,
        )
    from ps_pytorch_tpu_torch.parallel.async_dp import tree_flatten

    n, lr = 4, 0.05
    outage = range(8, 15)           # steps where group 1 is cut off
    events = []
    grad = grad or _lenet_free_grad
    if params0 is None:
        rng = np.random.default_rng(0)
        params0 = {"w": rng.standard_normal(513).astype(np.float32)}

    def make_agg(on_event=None):
        return agg_cls(n, group_size=2, staleness_limit=4,
                       staleness_decay=0.5, codec="int8lat",
                       error_feedback=True, hop_ef=True, on_event=on_event)

    def run(t0, p0, agg, ckpt_at=None):
        p, ckpt = {k: v.copy() for k, v in p0.items()}, None
        for t in range(t0, total_steps):
            for i in range(n):
                if i >= 2 and t in outage:
                    continue        # group 1 cut off from the root
                agg.submit(i, t, grad(i, t))
            avg, info = agg.collect(t)
            if avg is not None:
                p = {k: (p[k] - lr * np.asarray(avg[k], np.float32)
                         ).astype(np.float32) for k in p}
            agg.consume(info["used"])
            agg.drop_older_than(t)
            if ckpt_at is not None and t == ckpt_at:
                if agg._members._pool or agg.root._pool or any(
                        g.inner._pool for g in agg._groups):
                    raise AssertionError(
                        "checkpoint taken with in-flight contributions")
                ckpt = ({k: v.copy() for k, v in p.items()},
                        agg.ef_state_dict())
        return p, ckpt

    agg = make_agg(lambda kind, gid, step, st:
                   events.append((kind, gid, step, st)))
    final, ckpt = run(0, params0, agg, ckpt_at=resume_step - 1)
    counters = dict(agg.root.counters)

    p_ck, ef_state = ckpt
    agg2 = make_agg()
    agg2.load_ef_state(ef_state)
    final2, _ = run(resume_step, p_ck, agg2)
    bitwise = all(np.array_equal(final[k], final2[k]) for k in final)
    digest = hashlib.sha256()
    for leaf in tree_flatten(final)[0]:
        digest.update(np.ascontiguousarray(leaf, np.float32).tobytes())
    return {"ok": bitwise and counters["partitions"] >= 1
            and counters["regrafts"] >= 1
            and counters["degraded_steps"] >= 1,
            "bitwise_equal": bitwise, "resume_step": resume_step,
            "total_steps": total_steps, "counters": counters,
            "events": [list(e) for e in events],
            "final_sha256": digest.hexdigest(), "final": final}


def _phase_bench() -> dict:
    """The hier-against-flat latency row at drill scale (small payload,
    one rep), the JAX drill's arguments."""
    from ps_pytorch_tpu_torch import bench_suite
    return bench_suite.bench_hier_agg(
        "drill_hier_bench", 1, payload_mb=2, leaf_kb=256,
        n_slices=4, group_size=2)


# ----------------------------------------------------------------- drill

def parse_partition(logs, rc: int) -> dict:
    """The partition phase's evidence from the four logs: the root's
    lifecycle lines and summary, the DRILLSTATS counters, the FINALs."""
    all_logs = "\n".join(logs)
    partitioned = re.search(r"HIER partition group 1 at version (\d+)",
                            logs[0])
    regrafted = re.search(r"HIER regraft group 1 at version (\d+)", logs[0])
    finals = [i for i, t in enumerate(logs) if "FINAL" in t]
    summary = re.search(
        r"HIERARCHY pid 0 .* partitions (\d+) regrafts (\d+) "
        r"degraded_steps (\d+) groups_healthy (\d+)", logs[0])
    stats = {int(m.group(1)): json.loads(m.group(2)) for m in re.finditer(
        r"DRILLSTATS pid (\d+) (\{.*\})", all_logs)}
    drops = sum(s.get("kv_partition_drops", 0) for s in stats.values())
    p_part, p_regraft, p_degraded, p_healthy = (
        map(int, summary.groups()) if summary else (0, 0, 0, 0))
    ok = (rc != 2 and partitioned is not None and regrafted is not None
          and len(finals) == 4 and p_part >= 1 and p_regraft >= 1
          and p_degraded >= 1 and p_healthy == 2 and drops > 0)
    return {"ok": ok, "rc": rc, "finals": finals,
            "partitions": p_part, "regrafts": p_regraft,
            "degraded_steps": p_degraded, "groups_healthy_final": p_healthy,
            "kv_partition_drops": int(drops),
            "hop_giveups": sum(s.get("hop_giveups", 0)
                               for s in stats.values()),
            "kv_giveups": sum(s.get("kv_giveups", 0)
                              for s in stats.values()),
            "failovers": sum(s.get("failovers", 0) for s in stats.values()),
            "declared_at_version":
                int(partitioned.group(1)) if partitioned else -1,
            "regrafted_at_version":
                int(regrafted.group(1)) if regrafted else -1,
            "per_process_stats": stats}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phase", default="all",
                    choices=("all", "partition", "bitwise", "bench",
                             "worker"),
                    help="which phase to run (worker: one process of the "
                         "partition phase, started by the launcher)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--train-dir", default="")
    ap.add_argument("--max-steps", type=int, default=60)
    ap.add_argument("--cut-step", type=int, default=6)
    ap.add_argument("--cut-steps", type=int, default=6)
    ap.add_argument("--run-dir", default="",
                    help="logs and the train dir (default: a new "
                         "temporary directory)")
    ap.add_argument("--out", default="",
                    help="the artifact (default: <run-dir>/"
                         "hierarchy_drill.json)")
    args = ap.parse_args(argv)

    if args.phase == "worker":
        _worker_partition(args)
        return 0
    base = pathlib.Path(args.run_dir or tempfile.mkdtemp(
        prefix="hierarchy_drill_"))
    out = _drill.artifact_path(args.out, base, "hierarchy_drill.json",
                               ARTIFACT_NOT_WRITTEN)
    art = {"platform": args.device, "processes": 4,
           "scenario": "hier_subtree_partition_degrade_regraft + "
                       "bitwise_ef_resume + hier_vs_flat_bench",
           "phases": {}}
    ok = True
    if args.phase in ("all", "partition"):
        d1 = base / "partition"
        shutil.rmtree(d1, ignore_errors=True)
        worker = ["--phase", "worker", "--device", args.device,
                  "--train-dir", str(d1 / "ckpt"),
                  "--max-steps", str(args.max_steps),
                  "--cut-step", str(args.cut_step),
                  "--cut-steps", str(args.cut_steps)]
        rc = _drill.launch(d1, 4, ENTRY, worker)
        logs = _drill.logs(d1, 4)
        p1 = parse_partition(logs, rc)
        p1.update(cut_step=args.cut_step, cut_steps=args.cut_steps,
                  max_steps=args.max_steps)
        print(f"PHASE partition ok={p1['ok']} declared="
              f"{p1['declared_at_version']} regrafted="
              f"{p1['regrafted_at_version']} finals={p1['finals']} "
              f"partitions={p1['partitions']} regrafts={p1['regrafts']} "
              f"degraded_steps={p1['degraded_steps']} kv_drops="
              f"{p1['kv_partition_drops']} hop_giveups={p1['hop_giveups']}",
              flush=True)
        if not p1["ok"]:
            print(_drill.dump(logs))
        art["phases"]["partition"] = p1
        art["hierarchy"] = {k: p1[k] for k in (
            "partitions", "regrafts", "degraded_steps",
            "groups_healthy_final", "failovers", "hop_giveups",
            "kv_giveups")}
        art["counters"] = {"kv_partition_drops": p1["kv_partition_drops"]}
        ok = ok and p1["ok"]
    if args.phase in ("all", "bitwise"):
        p2 = _phase_bitwise()
        p2.pop("final")
        print(f"PHASE bitwise ok={p2['ok']} bitwise_equal="
              f"{p2['bitwise_equal']} counters={p2['counters']} events="
              f"{p2['events']}", flush=True)
        art["phases"]["bitwise"] = p2
        art["bitwise_equal"] = p2["bitwise_equal"]
        ok = ok and p2["ok"]
    if args.phase in ("all", "bench"):
        p3 = _phase_bench()
        p3_ok = p3["speedup"] > 1.0 and p3["rel_err"] < 0.05
        print(f"PHASE bench ok={p3_ok} flat_s={p3['flat_s']} "
              f"hier_s={p3['hier_s']} speedup={p3['speedup']}", flush=True)
        art["phases"]["bench"] = p3
        art.setdefault("hierarchy", {})["bench"] = {
            k: p3[k] for k in ("flat_s", "hier_s", "speedup", "rel_err")}
        ok = ok and p3_ok
    art["ok"] = bool(ok)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(art, indent=1))
    print(f"WROTE {out} ok={ok}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
