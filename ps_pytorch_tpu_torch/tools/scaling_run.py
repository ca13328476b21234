#!/usr/bin/env python
"""One-command scaling table: launch -> analyze -> artifact. The JAX
package's ``tools/scaling_run.py`` (its flags, cells, modes, JSON and
markdown) over the port's launcher and ``analyze``.

The reference's headline artifacts are speedup-vs-{1,2,4,8,16,32}-worker
tables built offline from per-worker logs (``analysis/Speedup_Comparisons_
LeNet.ipynb`` cell 6, ``analysis/Speedups_with_GradCompression.ipynb`` cell
3; mirrored in BASELINE.md). This tool produces the same artifact for this
framework in one command: for each (mode, world size) cell it runs
the port's ``tools/launch.py --simulate N`` (N OS processes over the
launcher's env contract and a process group, per-process input shards),
then feeds the per-process STEP logs to
``tools/analyze.py``'s max/min-per-step computation — "normal" speedup is
the slowest worker, "ideal" the fastest, exactly the notebooks' definition.

    python -m ps_pytorch_tpu_torch.tools.scaling_run --device cpu \
        --out /tmp/scaling.json --markdown /tmp/scaling.md

Semantics per mode (strong scaling — fixed global work per applied step,
like the reference's fixed-batch tables):
- sync:  SPMD allreduce; --batch-size is the global batch, sharded N ways.
- kofn:  same, but each step waits for only K=N-1 of N replicas (N>1).
- async: one slice per process, per-slice batch = global/N; gradients cross
  process boundaries through the process group's store (stale-gradient
  pool), so its curve is the PS-async analogue of the reference's
  ``sync_replicas_master_nn.py`` pool.

With ``--device cpu`` the numbers are CPU numbers (``platform``
``cpu-simulate``, gloo). With ``--device cuda`` (the default) rank r of a
cell runs on ``cuda:{r % cards}``: a cell of N ranks on a host of at
least N cards runs one rank a card over NCCL, and the table's
``platform`` is ``gpu`` when every cell does; ranks that share a card
reduce over gloo (``gpu-simulate``, ``parallel/dist.py:choose_backend``).
Each row records its cell's ``backend`` (the MESH line's, else that rule)
and ``cards``. On shared cards or CPU cores the curve *shape* and the
normal-vs-ideal gap are the reproducible content, as in the reference's
m4.2xlarge tables. The artifact is written only where ``--out`` and
``--markdown`` say; the JAX ``SCALING_r04.*`` are never written.
"""

import argparse
import json
import os
import re
import sys
import tempfile
import time
from typing import Dict, List

from ps_pytorch_tpu_torch.parallel import dist
from ps_pytorch_tpu_torch.tools import analyze as analyze_mod
from ps_pytorch_tpu_torch.tools import launch as launch_mod

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ARTIFACTS_NOT_WRITTEN = ("SCALING_r04.json", "SCALING_r04.md")


def _train_argv(mode: str, n: int, args) -> List[str]:
    if mode == "async":
        batch = max(args.batch_size // n, 1)
    else:
        batch = args.batch_size
    argv = [
        "--network", args.network, "--dataset", args.dataset,
        "--batch-size", str(batch), "--max-steps", str(args.steps),
        "--eval-freq", "0", "--resume", "false", "--log-every", "1",
        "--compute-dtype", "float32", "--mode", mode,
        "--device", args.device,
    ]
    if mode == "kofn":
        argv += ["--num-aggregate", str(max(n - 1, 1))]
    if mode == "async":
        argv += ["--staleness-limit", str(args.staleness_limit)]
        if n == 1:
            # Single process -> MultiSliceTrainer with device-group slices
            # (train's dispatch); 1 device can host only 1 group. N>1 uses
            # AsyncTrainer process-slices and ignores async_slices.
            argv += ["--async-slices", "1"]
    if args.inject_step_delay and n > 1:
        argv += ["--inject-step-delay", str(args.inject_step_delay),
                 "--inject-delay-process", str(n - 1)]
    return argv


def run_cell(mode: str, n: int, args, work: str):
    """Launch one (mode, N) run; -> (per-process log paths, cell wall s)."""
    run_dir = os.path.join(work, f"{mode}_n{n}")
    ckpt = os.path.join(run_dir, "ckpt")
    logs = [os.path.join(run_dir, f"proc_{i}.log") for i in range(n)]
    # Resume: with --work-dir, completed cells (every process reached its
    # FINAL line AND the cell was produced by identical run parameters) are
    # reused instead of re-run. The params stamp prevents a reused work dir
    # from silently serving stale cells under a new header.
    stamp_path = os.path.join(run_dir, "cell_params.json")
    stamp = json.dumps({"argv": _train_argv(mode, n, args)}, sort_keys=True)
    wall_path = os.path.join(run_dir, "cell_wall_s.txt")
    if (os.path.exists(stamp_path)
            and open(stamp_path).read() == stamp
            and all(os.path.exists(l) and "FINAL" in open(l).read()
                    for l in logs)):
        print(f"[scaling] {mode} N={n} cached in {run_dir}", flush=True)
        if not os.path.exists(wall_path):
            # Pre-wall-tracking cell: its cost is unknown, not zero — the
            # caller marks the artifact's wall_s incomplete.
            print(f"[scaling] {mode} N={n} has no cell_wall_s.txt; "
                  "wall_s will be marked incomplete", flush=True)
            return logs, None
        return logs, float(open(wall_path).read())
    if os.path.exists(stamp_path):
        # A re-run with new params must not leave the old stamp next to new
        # logs: if this launch fails partway, a later run with the OLD
        # params would otherwise serve these logs from cache.
        os.remove(stamp_path)
    cell_t0 = time.time()
    rc = launch_mod.main([
        "launch", "--run-dir", run_dir, "--simulate", str(n),
        "--devices-per-host", "1", "--port", str(launch_mod.free_port()),
        "--entry", "ps_pytorch_tpu_torch.train", "--cwd", REPO,
        "--wait", "--timeout", str(args.timeout),
        "--",
        *_train_argv(mode, n, args), "--train-dir", ckpt,
    ])
    if rc != 0:
        tail = ""
        for log in logs:
            if os.path.exists(log):
                with open(log) as f:
                    tail += f"\n== {log} ==\n" + f.read()[-2000:]
        raise RuntimeError(f"{mode} N={n} launch failed rc={rc}{tail}")
    wall = time.time() - cell_t0
    with open(wall_path, "w") as f:
        f.write(f"{wall:.3f}")
    with open(stamp_path, "w") as f:
        f.write(stamp)
    return logs, wall


def _cards(device: str) -> int:
    if device == "cpu":
        return 0
    import torch
    return torch.cuda.device_count()


def cell_backend(logs: List[str], n: int, device: str) -> str:
    """The backend a cell's ranks reduced over: process 0's MESH line's,
    else the rule that picked it (``dist.choose_backend``)."""
    try:
        with open(logs[0]) as f:
            found = re.search(r"^MESH .*backend=(\w+)", f.read(), re.M)
    except OSError:
        found = None
    if found:
        return found.group(1)
    return dist.choose_backend("cpu" if device == "cpu" else "cuda", n,
                               _cards(device))


def build_table(args, work: str) -> dict:
    sizes = [int(s) for s in args.sizes.split(",")]
    modes = args.modes.split(",")
    cells_wall = 0.0
    cards = _cards(args.device)
    on_cards = args.device != "cpu" and max(sizes) <= cards
    result: dict = {
        "artifact": "scaling",
        "network": args.network, "dataset": args.dataset,
        "global_batch": args.batch_size, "steps_per_run": args.steps,
        "platform": ("gpu" if on_cards else
                     f"{'cpu' if args.device == 'cpu' else 'gpu'}-simulate"),
        # N processes timeshare these cores: wall-clock speedup is only
        # meaningful up to host_cpus; past that the table's content is the
        # normal-vs-ideal gap (straggler story), not throughput.
        "host_cpus": os.cpu_count(),
        "note": ("strong scaling, fixed global batch; normal=slowest worker, "
                 "ideal=fastest (reference notebook max/min-per-step)"),
        "sizes": sizes, "modes": {},
    }
    for mode in modes:
        runs: Dict[str, List[str]] = {}
        for n in sizes:
            print(f"[scaling] {mode} N={n} ...", flush=True)
            runs[str(n)], cell_wall = run_cell(mode, n, args, work)
            if cell_wall is None:
                result["wall_s_incomplete"] = True
            else:
                cells_wall += cell_wall
        rows = analyze_mod.analyze(runs, baseline=str(min(sizes)),
                                   skip_first=args.skip_first)
        for row in rows:
            n = int(row["run"])
            row["backend"] = cell_backend(runs[row["run"]], n, args.device)
            row["cards"] = min(n, cards)
        result["modes"][mode] = rows
        print(analyze_mod.to_markdown(rows), flush=True)
    # Sum of per-cell launch walls (persisted next to each cell), so a
    # resume-cached rebuild still reports what the measurements cost rather
    # than the near-zero harvesting time.
    result["wall_s"] = round(cells_wall, 1)
    return result


def to_markdown(result: dict) -> str:
    lines = [
        "# Scaling table (generated by `python -m "
        "ps_pytorch_tpu_torch.tools.scaling_run`)",
        "",
        f"{result['network']}/{result['dataset']}, global batch "
        f"{result['global_batch']}, {result['steps_per_run']} steps/run, "
        f"platform **{result['platform']}** (the `--simulate` multi-host rig "
        "— curve shape, not chip throughput). \"normal\" = slowest worker per "
        "step, \"ideal\" = fastest — the reference notebooks' max/min-per-step "
        "computation (BASELINE.md).",
        "",
    ]
    if result["platform"] == "gpu":
        lines += ["Every cell ran one rank a card: the backend of each "
                  "size is " + ", ".join(
                      f"N={r['run']} {r['backend']}" for r in
                      next(iter(result["modes"].values()), [])) + ".", ""]
    cpus = result.get("host_cpus")
    if cpus:
        lines += [
            f"Host has **{cpus} CPU core(s)**: the N simulated hosts "
            "timeshare them, so wall-clock speedup is only physically "
            "possible up to that count — past it the table records the "
            "timesharing slope and the normal-vs-ideal straggler gap, not "
            "scaling. (The reference's tables came from one machine per "
            "worker.)",
            "",
        ]
    for mode, rows in result["modes"].items():
        lines += [f"## mode = {mode}", "", analyze_mod.to_markdown(rows), ""]
        normal = [r["speedup_normal"] for r in rows]
        ideal = [r["speedup_ideal"] for r in rows]
        lines += [f"normal: {normal}  ideal: {ideal}", ""]
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--sizes", default="1,2,4,8")
    p.add_argument("--modes", default="sync,kofn,async")
    p.add_argument("--network", default="LeNet")
    p.add_argument("--dataset", default="synthetic_mnist")
    p.add_argument("--batch-size", type=int, default=1024,
                   help="global batch (async: divided per process)")
    p.add_argument("--steps", type=int, default=12)
    p.add_argument("--skip-first", type=int, default=2,
                   help="drop compile-dominated leading steps")
    p.add_argument("--staleness-limit", type=int, default=8)
    p.add_argument("--inject-step-delay", type=float, default=0.0,
                   help="straggle the last process by this many seconds/step "
                        "(shows the normal-vs-ideal gap on a uniform host)")
    p.add_argument("--timeout", type=int, default=900)
    p.add_argument("--out", default="")
    p.add_argument("--markdown", default="")
    p.add_argument("--work-dir", default="",
                   help="keep run logs here (default: temp dir)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    for path in (args.out, args.markdown):
        if path and os.path.basename(path) in ARTIFACTS_NOT_WRITTEN:
            p.error(f"{path} is a JAX artifact; write this table elsewhere")
    if args.device == "cuda":
        from ps_pytorch_tpu_torch.runtime.trainer import resolve_device
        resolve_device("cuda")          # no card: raise before any launch

    if args.work_dir:
        os.makedirs(args.work_dir, exist_ok=True)
        result = build_table(args, args.work_dir)
    else:
        with tempfile.TemporaryDirectory(prefix="scaling_") as work:
            result = build_table(args, work)

    blob = json.dumps(result, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(blob + "\n")
        print(f"[scaling] wrote {args.out}")
    else:
        print(blob)
    if args.markdown:
        with open(args.markdown, "w") as f:
            f.write(to_markdown(result) + "\n")
        print(f"[scaling] wrote {args.markdown}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
