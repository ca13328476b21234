#!/usr/bin/env python
"""Learning-rate sweep harness: the JAX package's ``tools/sweep.py`` (its
flags, trials, JSON lines and ``BEST`` line) over the port's entry points.

Replaces ``tune.sh`` + ``tiny_tuning_parser.py``: the reference grid-sweeps
seven learning rates by re-launching a 17-rank mpirun job per value
(``tune.sh:1-36``) and regex-averages the step-N loss across its 16 workers
(``tiny_tuning_parser.py:14-26``). Here each trial is one subprocess running
the port's trainer (``python -m ps_pytorch_tpu_torch.<entry>``); the loss
at the probe step is parsed from the STEP line schema
(``runtime/metrics.parse_line``), the parser the analysis tools share.

    python -m ps_pytorch_tpu_torch.tools.sweep --lrs 0.01,0.05,0.1 \\
        --probe-step 20 -- --network LeNet --dataset synthetic_mnist \\
        --batch-size 256

The same harness sweeps the LM entry point (both emit the STEP schema):

    python -m ps_pytorch_tpu_torch.tools.sweep --entry train_lm \\
        --lrs 0.05,0.1,0.3 -- --lm-seq-len 1024 --batch-size 8

``--entry`` names the port's entry module (``train`` or ``train_lm``).
``--device`` (default ``cuda``) goes to every trial; ``--device cpu`` runs
the plain versions on the CPU. Prints one JSON line per trial and a final
``BEST`` line.
"""

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path
from typing import List, Optional

from ps_pytorch_tpu_torch.runtime.metrics import parse_line

REPO = Path(__file__).resolve().parents[2]
ENTRIES = ("train", "train_lm")


def run_trial(lr: float, probe_step: int, train_argv: List[str],
              entry: str = "train", avg_last: int = 1,
              schedule: str = "constant",
              extra_env: Optional[dict] = None,
              device: str = "cuda") -> dict:
    """One training subprocess at this (lr, schedule);
    -> {"lr", "schedule", "loss", "acc", "steps"}."""
    import os
    if entry not in ENTRIES:
        raise ValueError(f"entry {entry!r}: the port's entries are "
                         f"{', '.join(ENTRIES)}")
    cmd = [sys.executable, "-m", f"ps_pytorch_tpu_torch.{entry}",
           "--device", device, "--lr", str(lr),
           "--lr-schedule", schedule,
           "--max-steps", str(probe_step), "--log-every", "1",
           "--eval-freq", "0", "--resume", "false"] + train_argv
    env = dict(os.environ)
    env.update(extra_env or {})
    out = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         cwd=REPO)
    records = [r for r in (parse_line(l) for l in out.stdout.splitlines()) if r]
    if out.returncode != 0 or not records:
        return {"lr": lr, "schedule": schedule, "loss": float("nan"),
                "acc": float("nan"), "steps": len(records),
                "error": out.stderr[-500:]}
    # Average the last k probe losses (the reference averages its 16 workers'
    # step-N lines; one SPMD process emits one line per step, so average over
    # trailing steps for the same smoothing effect).
    tail = records[-avg_last:]
    return {"lr": lr, "schedule": schedule,
            "loss": statistics.fmean(r["loss"] for r in tail),
            "acc": statistics.fmean(r["acc"] for r in tail),
            "steps": len(records)}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if "--" in argv:
        i = argv.index("--")
        argv, train_argv = argv[:i], argv[i + 1:]
    else:
        train_argv = []
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--lrs", default="0.005,0.01,0.02,0.05,0.1,0.2,0.4",
                   help="comma-separated grid (7 values, like tune.sh)")
    p.add_argument("--schedules", default="constant",
                   help="comma-separated lr_schedule axis "
                        "(constant|step|cosine); grid = lrs x schedules")
    p.add_argument("--probe-step", type=int, default=20,
                   help="train this many steps; rank by loss there")
    p.add_argument("--avg-last", type=int, default=3)
    p.add_argument("--entry", default="train", choices=ENTRIES)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)

    results = []
    for schedule in args.schedules.split(","):
        for lr in (float(s) for s in args.lrs.split(",")):
            r = run_trial(lr, args.probe_step, train_argv, entry=args.entry,
                          avg_last=args.avg_last, schedule=schedule.strip(),
                          device=args.device)
            print(json.dumps(r))
            results.append(r)
    valid = [r for r in results if r["loss"] == r["loss"]]  # drop NaNs
    if not valid:
        print("BEST none (all trials failed)", file=sys.stderr)
        return 1
    best = min(valid, key=lambda r: r["loss"])
    print(f"BEST lr={best['lr']:g} schedule={best['schedule']} "
          f"loss={best['loss']:.6f} acc={best['acc']:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
