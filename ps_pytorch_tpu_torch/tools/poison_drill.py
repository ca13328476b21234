#!/usr/bin/env python
"""Poisoned-contributor chaos drill of the gradient-integrity plane: the
JAX package's ``tools/poison_drill.py`` (its phases, printed lines and
artifact) on the port's modules.

- **clean** (four processes): LeNet trained flat async over the process
  group's store through the port's ``tools/launch.py --simulate 4``
  (int8lat wire, ``--grad-integrity`` on), no faults: the baseline.
- **poison** (four processes): the same run with process 2 poisoned
  (``grad_poison:scale=1e38`` over a window of its own steps, on the
  real wire) and the leader's gradient reads bit-flipped at low
  probability (``payload_bitflip``: in-alphabet flips that only the
  digests catch). The leader must quarantine contributor 2 (``INTEGRITY
  quarantine contributor 2``), keep training on the three clean ones,
  readmit it on probation after the window (``INTEGRITY readmit``), and
  end within 0.75 of the clean final loss. Nobody crashes.
- **poison_ef**: the same poison with error feedback on and the residual
  clamp (``--ef-clip``): the offender is still quarantined and the run
  stays finite.
- **control**: the same poison with ``--grad-integrity false``: the run
  diverges, the evidence that the screen carries the load.
- **bitwise** (in one process, deterministic): four contributors through
  the port's ``StaleGradientAggregator``, contributor 3 submitting
  1e8-scaled payloads for a window, quarantined, then readmitted; a
  control aggregator fed exactly the admitted sets ends on the same bits.

- **bench** (in one process): the integrity-overhead row of the port's
  ``bench_suite.bench_integrity_overhead`` at the JAX drill's scale (20
  steps, 2 reps): the per-step digest and screen cost of a 4-contributor
  LeNet round on ``--device``, the artifact's ``integrity.overhead_frac``
  (the regress ``integrity`` family's 2% budget). ``--phase bench`` runs
  it alone and writes an artifact with that section only.

The window is counted in the poisoner's own steps, the run in leader
versions. The JAX defaults (16 poisoned steps of 40 versions) suit the
port's LeNet on the CPU as they stand: a follower takes about one step a
leader version there, so the window spans ~16 screenings, enough for the
three strikes, and the ~20 versions after it for the three clean
screens of the readmission. Where a follower takes several steps a
leader version (ResNet-18 on the card, ``chip_smoke.py`` MAIN-POISON),
the window must be widened to span the strikes in versions.

    python -m ps_pytorch_tpu_torch.tools.poison_drill --device cpu \\
        --out /tmp/poison_drill.json

The artifact is this drill's own (``--out``, by default inside the run
directory); the JAX drill's ``RESILIENCE_r16.json`` is never written.
"""

import argparse
import json
import pathlib
import re
import shutil
import sys
import tempfile

from ps_pytorch_tpu_torch.tools import _drill

ARTIFACT_NOT_WRITTEN = "RESILIENCE_r16.json"
ENTRY = "ps_pytorch_tpu_torch.tools.poison_drill"


# ---------------------------------------------------------------- workers

def worker_args(args) -> list:
    """The train flags of one process (the JAX drill's config). The fault
    spec is armed on every process: ``grad_poison:r=2`` scopes itself to
    process 2's own encodes, ``payload_bitflip`` to gradient-chunk reads
    (only the leader reads those). Two KV attempts: a corrupted read
    demotes fast instead of stalling the poll loop.

    Error feedback is off in the main poison leg: EF on a poisoned
    contributor re-emits the poison as a residual for several steps after
    the window, a contributor that keeps poisoning, and the readmission
    arc needs it to go clean. The ``--ef`` leg turns EF on with the
    ``--ef-clip`` residual clamp."""
    return [
        "--device", args.device, "--dataset", "synthetic_mnist",
        "--network", "LeNet", "--batch-size", "64", "--lr", "0.05",
        "--momentum", "0.9", "--compute-dtype", "float32", "--mode",
        "async", "--max-steps", str(args.max_steps), "--eval-freq", "0",
        "--train-dir", args.train_dir, "--resume", "false", "--log-every",
        "4", "--seed", "42", "--compress-grad", "true", "--grad-codec",
        "int8lat", "--ef", str(bool(args.ef)).lower(), "--ef-clip",
        str(args.ef_clip if args.ef else 0.0), "--staleness-limit", "4",
        "--kv-retry-attempts", "2", "--grad-integrity",
        str(not args.no_integrity).lower(), "--fault-spec", args.fault_spec]


def _worker(args) -> None:
    """One training process: ``train.run`` (FINAL and the store's exit
    handshake included), then one DRILLSTATS line."""
    from ps_pytorch_tpu_torch import train

    t, _ = train.run(worker_args(args))
    stats = {}
    if t.injector is not None:
        stats.update(t.injector.snapshot())
    if t._retrier is not None:
        stats.update(t._retrier.snapshot())
    stats.update(t.transport.wire_stats())
    if t._integrity is not None or t._group_integrity is not None:
        stats.update(t._integrity_snapshot())
    print(f"DRILLSTATS pid {t.pid} {json.dumps(stats)}", flush=True)


# ----------------------------------------------------- in-process phases

def _phase_bitwise(total_steps: int = 24) -> dict:
    """The deterministic quarantine arc and its bitwise-exclusion proof:
    contributor 3 submits 1e8-scaled payloads (the validators pass them;
    the MAD norm gate must catch them) over a window, is quarantined at
    the third strike, streaks clean after it and is readmitted on
    probation. A ledger-free control aggregator gets exactly the admitted
    set each round; both SGD recurrences must end on the same bits."""
    import numpy as np

    from ps_pytorch_tpu_torch.compression.codecs import encode_leaves
    from ps_pytorch_tpu_torch.parallel.async_dp import (
        StaleGradientAggregator,
    )
    from ps_pytorch_tpu_torch.resilience.integrity import GradIntegrity

    n, size, lr = 4, 257, 0.05
    poison = range(4, 10)           # contributor 3's outlier window
    events = []
    gi = GradIntegrity(mad_threshold=6.0, strike_limit=3, readmit_clean=3,
                       on_event=lambda k, c, s, d: events.append((k, c, s)))

    def make_agg(integrity):
        return StaleGradientAggregator(
            n, staleness_limit=4, num_aggregate=0, compress=True,
            codec="int8lat", integrity=integrity)

    def wire(i, t, scale=1.0):
        # The port's pools flatten dict trees (a list is one leaf there),
        # so the one encoded leaf rides under a key.
        rng = np.random.default_rng(500 + 31 * i + t)
        g = rng.standard_normal(size).astype(np.float32) * scale
        return {"g": encode_leaves("int8lat", [g], slice_id=i, step=t)[0]}

    screened, control = make_agg(gi), make_agg(None)
    rng = np.random.default_rng(0)
    p = rng.standard_normal(size).astype(np.float32)
    p_ctl = p.copy()
    rejected_rounds = 0
    for t in range(total_steps):
        for i in range(n):
            scale = 1e8 if (i == 3 and t in poison) else 1.0
            screened.submit_encoded(i, t, wire(i, t, scale))
        avg, info = screened.collect(t)
        if info.get("rejected"):
            rejected_rounds += 1
        for i in info["used"]:
            control.submit_encoded(i, t, wire(i, t))
        avg_ctl, info_ctl = control.collect(t)
        assert info_ctl["used"] == info["used"]
        if avg is not None:
            p = (p - lr * np.asarray(avg["g"], np.float32)
                 ).astype(np.float32)
        if avg_ctl is not None:
            p_ctl = (p_ctl - lr * np.asarray(avg_ctl["g"], np.float32)
                     ).astype(np.float32)
        screened.consume(info["used"])
        control.consume(info_ctl["used"])
        screened.drop_older_than(t)
        control.drop_older_than(t)
    bitwise = bool(np.array_equal(p, p_ctl))
    snap = gi.snapshot()
    return {"ok": bitwise and snap["integrity_quarantines"] >= 1
            and snap["integrity_readmissions"] >= 1
            and snap["integrity_outlier_rejects"] >= 3
            and snap["integrity_quarantined"] == 0,
            "bitwise_equal": bitwise, "total_steps": total_steps,
            "rejected_rounds": rejected_rounds, "counters": snap,
            "events": [list(e) for e in events]}


def _phase_bench(device: str = "cuda") -> dict:
    """The integrity_overhead row at drill scale, the JAX drill's
    arguments, on ``device``."""
    from ps_pytorch_tpu_torch import bench_suite
    return bench_suite.bench_integrity_overhead(
        "poison_drill_bench", 20, reps=2, device=device)


def run_bench(device: str) -> dict:
    bench = _phase_bench(device)
    print(f"PHASE bench ok={bench['ok']} overhead_frac="
          f"{bench['overhead_frac']}", flush=True)
    return bench


# ------------------------------------------------------------- evidence

def final_losses(logs) -> dict:
    out = {}
    for i, text in enumerate(logs):
        m = re.search(r"FINAL loss ([-\w.+]+) ", text)
        if m:
            out[i] = float(m.group(1))
    return out


def parse_clean(logs, rc: int) -> dict:
    finals = final_losses(logs)
    ok = rc != 2 and len(finals) == 4 and all(
        v == v and v < 10 for v in finals.values())
    return {"ok": ok, "rc": rc, "finals": finals}


def parse_poison(logs, rc: int, loss_clean: float) -> dict:
    """The poison leg's evidence: the leader's INTEGRITY lines and
    summary, the DRILLSTATS counters, the FINAL losses."""
    finals = final_losses(logs)
    quarantined = re.search(
        r"INTEGRITY quarantine contributor 2 at version (\d+)", logs[0])
    readmitted = re.search(
        r"INTEGRITY readmit contributor 2 at version (\d+)", logs[0])
    summary = re.search(
        r"INTEGRITY pid 0 screen_rejects (\d+) outlier_rejects (\d+) "
        r"strikes (\d+) quarantines (\d+) readmissions (\d+) "
        r"wire_failures (\d+)", logs[0])
    stats = {int(m.group(1)): json.loads(m.group(2)) for m in re.finditer(
        r"DRILLSTATS pid (\d+) (\{.*\})", "\n".join(logs))}
    rejects, _, strikes, quar, readmit, wire = (
        map(int, summary.groups()) if summary else (0,) * 6)
    poisons = sum(s.get("grad_poisons", 0) for s in stats.values())
    bitflips = sum(s.get("payload_bitflips", 0) for s in stats.values())
    loss = finals.get(0, float("nan"))
    gap = abs(loss - loss_clean)
    ok = (rc != 2 and len(finals) == 4
          and all(v == v for v in finals.values())
          and quarantined is not None and readmitted is not None
          and quar >= 1 and readmit >= 1 and rejects >= 3
          and wire >= 1 and poisons >= 3 and bitflips >= 1
          and gap == gap and gap < 0.75)
    return {"ok": ok, "rc": rc, "finals": finals,
            "quarantined_at_version":
                int(quarantined.group(1)) if quarantined else -1,
            "readmitted_at_version":
                int(readmitted.group(1)) if readmitted else -1,
            "screen_rejects": rejects, "strikes": strikes,
            "quarantines": quar, "readmissions": readmit,
            "wire_integrity_failures": wire, "grad_poisons": int(poisons),
            "payload_bitflips": int(bitflips), "loss": loss,
            "loss_gap": gap, "per_process_stats": stats}


def parse_poison_ef(logs, rc: int) -> dict:
    finals = final_losses(logs)
    quarantined = re.search(
        r"INTEGRITY quarantine contributor 2 at version (\d+)", logs[0])
    ok = (rc != 2 and len(finals) == 4
          and all(v == v for v in finals.values())
          and quarantined is not None)
    return {"ok": ok, "rc": rc, "finals": finals,
            "quarantined_at_version":
                int(quarantined.group(1)) if quarantined else -1}


def parse_control(logs, rc: int, loss_clean: float) -> dict:
    """Divergence: a non-finite loss or one an order of magnitude off the
    clean baseline."""
    finals = final_losses(logs)
    loss = finals.get(0, float("nan"))
    diverged = bool(loss != loss or abs(loss) > 10 * max(loss_clean, 0.1))
    return {"ok": rc != 2 and diverged, "rc": rc, "finals": finals,
            "diverged": diverged}


def build_artifact(args, clean: dict, poison: dict, poison_ef: dict,
                   control: dict, bitwise: dict, bench=None) -> dict:
    """The JAX drill's artifact (the regress ``integrity`` family's
    contract). ``bench``: the integrity-overhead row; without one the
    artifact has no ``overhead_frac`` and is not ok."""
    bench_ok = bench is not None and bool(bench["ok"])
    ok = bool(clean["ok"] and poison["ok"] and poison_ef["ok"]
              and control["ok"] and bitwise["ok"] and bench_ok)
    return {
        "round": 16,
        "platform": args.device,
        "scenario": "poisoned_contributor_quarantine_readmit + "
                    "bitflip_wire_digests + no_screen_divergence_control "
                    "+ bitwise_exclusion + integrity_overhead_bench",
        "processes": 4,
        "ok": ok,
        "bitwise_equal": bitwise["bitwise_equal"],
        "counters": {"grad_poisons": poison["grad_poisons"],
                     "payload_bitflips": poison["payload_bitflips"]},
        "integrity": {
            "quarantines": poison["quarantines"],
            "readmissions": poison["readmissions"],
            "screen_rejects": poison["screen_rejects"],
            "strikes": poison["strikes"],
            "wire_integrity_failures": poison["wire_integrity_failures"],
            "crashes": 0 if (len(poison["finals"]) == 4
                             and poison["rc"] != 2) else 1,
            "loss_clean": clean["finals"].get(0, float("nan")),
            "loss_poisoned": poison["loss"],
            "loss_gap": round(poison["loss_gap"], 4),
            "control_diverged": control["diverged"],
            # No bench row, no overhead_frac: the gate's budget fails.
            **({} if bench is None else {
                "overhead_frac": bench["overhead_frac"],
                "bench": {k: bench[k] for k in (
                    "baseline_s", "integrity_s", "overhead_frac")}}),
        },
        "phases": {
            "clean": clean,
            "poison": dict({k: poison[k] for k in (
                "ok", "rc", "finals", "quarantined_at_version",
                "readmitted_at_version", "per_process_stats")},
                poison_step=args.poison_step,
                poison_steps=args.poison_steps, max_steps=args.max_steps),
            "poison_ef": dict(poison_ef, ef_clip=args.ef_clip),
            "control": control,
            "bitwise": bitwise,
            "bench": bench,
        },
    }


# ----------------------------------------------------------------- drill

def _run_leg(base: pathlib.Path, name: str, args, fault_spec: str = "",
             no_integrity: bool = False, ef: bool = False):
    d = base / name
    shutil.rmtree(d, ignore_errors=True)
    worker = ["--phase", "worker", "--device", args.device, "--train-dir",
              str(d / "ckpt"), "--max-steps", str(args.max_steps),
              "--fault-spec", fault_spec]
    if no_integrity:
        worker.append("--no-integrity")
    if ef:
        worker += ["--ef", "--ef-clip", str(args.ef_clip)]
    rc = _drill.launch(d, 4, ENTRY, worker)
    return rc, _drill.logs(d, 4)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phase", default="all",
                    choices=("all", "bench", "worker"),
                    help="all, the bench alone, or one training process "
                         "(worker, started by the launcher)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--train-dir", default="")
    ap.add_argument("--fault-spec", default="")
    ap.add_argument("--no-integrity", action="store_true")
    ap.add_argument("--ef", action="store_true",
                    help="worker: sender-side error feedback on (the EF x "
                         "integrity leg)")
    ap.add_argument("--ef-clip", type=float, default=1.0,
                    help="per-leaf residual L2 cap for the --ef leg")
    ap.add_argument("--max-steps", type=int, default=40)
    ap.add_argument("--poison-step", type=int, default=3)
    ap.add_argument("--poison-steps", type=int, default=16)
    ap.add_argument("--run-dir", default="",
                    help="logs and train dirs (default: a new temporary "
                         "directory)")
    ap.add_argument("--out", default="",
                    help="the artifact (default: <run-dir>/"
                         "poison_drill.json)")
    args = ap.parse_args(argv)

    if args.phase == "worker":
        _worker(args)
        return 0
    _drill.require_device(args.device)
    base = pathlib.Path(args.run_dir or tempfile.mkdtemp(
        prefix="poison_drill_"))
    out = _drill.artifact_path(args.out, base, "poison_drill.json",
                               ARTIFACT_NOT_WRITTEN)
    if args.phase == "bench":
        bench = run_bench(args.device)
        art = {"platform": args.device, "ok": bool(bench["ok"]),
               "integrity": {"overhead_frac": bench["overhead_frac"],
                             "bench": {k: bench[k] for k in (
                                 "baseline_s", "integrity_s",
                                 "overhead_frac")}},
               "phases": {"bench": bench}}
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(art, indent=1))
        print(f"WROTE {out} ok={art['ok']}")
        return 0 if art["ok"] else 1
    # scale=1e38 makes every poisoned payload a deterministic screen
    # reject: any leaf with absmax > ~1e-17 lands past the int8lat
    # exponent bound or at inf. The bit-flips are reader-side and
    # in-alphabet: the armour decodes them, only the digests catch them.
    poison_spec = (
        f"grad_poison:scale=1e38,r=2,step={args.poison_step},"
        f"steps={args.poison_steps};"
        f"payload_bitflip:p=0.01,seed=11,prefix=async-42/agrad")

    rc, logs = _run_leg(base, "clean", args)
    clean = parse_clean(logs, rc)
    print(f"PHASE clean ok={clean['ok']} finals={clean['finals']}")
    loss_clean = clean["finals"].get(0, float("nan"))

    rc, logs = _run_leg(base, "poison", args, fault_spec=poison_spec)
    poison = parse_poison(logs, rc, loss_clean)
    print(f"PHASE poison ok={poison['ok']} quarantined="
          f"{poison['quarantined_at_version'] >= 0} readmitted="
          f"{poison['readmitted_at_version'] >= 0} finals="
          f"{poison['finals']} screen_rejects={poison['screen_rejects']} "
          f"quarantines={poison['quarantines']} readmissions="
          f"{poison['readmissions']} wire_failures="
          f"{poison['wire_integrity_failures']} grad_poisons="
          f"{poison['grad_poisons']} bitflips={poison['payload_bitflips']} "
          f"loss_gap={poison['loss_gap']:.4f}")
    if not poison["ok"]:
        print(_drill.dump(logs))

    rc, logs = _run_leg(base, "poison_ef", args, fault_spec=poison_spec,
                        ef=True)
    poison_ef = parse_poison_ef(logs, rc)
    print(f"PHASE poison_ef ok={poison_ef['ok']} quarantined="
          f"{poison_ef['quarantined_at_version'] >= 0} finals="
          f"{poison_ef['finals']} ef_clip={args.ef_clip}")
    if not poison_ef["ok"]:
        print(_drill.dump(logs))

    rc, logs = _run_leg(base, "control", args, fault_spec=poison_spec,
                        no_integrity=True)
    control = parse_control(logs, rc, loss_clean)
    print(f"PHASE control ok={control['ok']} diverged="
          f"{control['diverged']} finals={control['finals']}")

    p4 = _phase_bitwise()
    print(f"PHASE bitwise ok={p4['ok']} bitwise_equal="
          f"{p4['bitwise_equal']} counters={p4['counters']}")
    bench = run_bench(args.device)

    art = build_artifact(args, clean, poison, poison_ef, control, p4, bench)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(art, indent=1))
    print(f"WROTE {out} ok={art['ok']}")
    return 0 if art["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
