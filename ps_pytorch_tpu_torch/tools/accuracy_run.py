#!/usr/bin/env python
"""Real-data time-to-accuracy harness: the JAX package's
``tools/accuracy_run.py`` (its flags, recipes, printed line and artifact)
through the port's entry points.

It drives the contract end to end: ``python -m ps_pytorch_tpu_torch.train``
writes checkpoints, ``python -m ps_pytorch_tpu_torch.evaluate --once``
scores the final ``model_step_<k>``, and the steps, wall-clock and
Prec@1/Prec@5 go into one JSON line and the artifact. It is the analogue of
the reference's accuracy oracle (the standalone evaluator scoring a
worker's checkpoints).

Default task: LeNet on ``Digits``, scikit-learn's bundled copy of the UCI
handwritten-digit scans (real data, no network) at MNIST geometry. ``--lm``
runs the LM oracle instead: ``train_lm`` on the framework's own ``.py``
bytes, scored by the evaluator's ``EVAL_LM`` line.

    python -m ps_pytorch_tpu_torch.tools.accuracy_run --device cpu \\
        --out /tmp/accuracy.json

``--device`` (default ``cuda``) goes to both children; with no card they
fail and so does the harness. The platform in the artifact is the one
torch reports for that device. The artifact is written only where
``--out`` says, and never to a JAX artifact's name (``ACCURACY*.json`` at
the root of the repo).
"""

import argparse
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

# Matches finite and nan/inf floats: a diverged run prints "loss nan" and
# is reported as divergence, not as a failed evaluator.
_FLOAT = r"([\d.eE+-]+|nan|inf)"


def probe_platform(device: str):
    """(platform, device kind) of ``device`` as torch sees it."""
    import torch
    if device.startswith("cuda") and torch.cuda.is_available():
        return "gpu", torch.cuda.get_device_name(0)
    return "cpu", "cpu"


def write_source_corpus(path: str, repo: Path = REPO) -> int:
    """A real byte corpus with no network: the ``.py`` bytes under
    ``ps_pytorch_tpu/`` and ``tests/``, read as files (never imported),
    joined by newlines, as the JAX harness writes it."""
    parts = []
    for top in ("ps_pytorch_tpu", "tests"):
        for root, _, files in sorted(os.walk(repo / top)):
            for name in sorted(files):
                if name.endswith(".py"):
                    parts.append((Path(root) / name).read_bytes())
    data = b"\n".join(parts)
    Path(path).write_bytes(data)
    return len(data)


def cnn_recipe(args) -> list:
    """The train flags of the CNN oracle (one checkpoint at the end)."""
    return ["--dataset", args.dataset, "--network", args.network,
            "--batch-size", str(args.batch_size), "--lr", str(args.lr),
            "--momentum", "0.9", "--weight-decay", "1e-4",
            "--compute-dtype", "float32", "--epochs", "0",
            "--max-steps", str(args.max_steps),
            "--eval-freq", str(args.max_steps), "--log-every", "200"]


def lm_recipe(max_steps: int) -> list:
    """The train_lm flags of the LM oracle. lr 0.1 with warmup and cosine:
    real source bytes are a harder stream than the synthetic corpus, and
    the synthetic recipe's lr 0.3 diverged on them in the JAX package."""
    return ["--lm-seq-len", "256", "--lm-d-model", "128", "--lm-layers",
            "2", "--lm-heads", "4", "--batch-size", "16", "--momentum",
            "0.9", "--lr", "0.1", "--lr-schedule", "cosine",
            "--lr-warmup-steps", "50", "--max-steps", str(max_steps),
            "--eval-freq", str(max_steps), "--log-every", "100"]


def _run_child(label: str, cmd, timeout_s: float):
    r = subprocess.run(cmd, capture_output=True, text=True,
                       timeout=timeout_s, cwd=REPO)
    if r.returncode != 0:
        raise RuntimeError(f"{label} failed rc={r.returncode}: "
                           f"{(r.stderr or r.stdout)[-400:]}")
    return r


def _module(name: str) -> list:
    return [sys.executable, "-m", f"ps_pytorch_tpu_torch.{name}"]


def _emit(result: dict, args) -> dict:
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


def run_lm(args, train_dir: str) -> dict:
    """The LM oracle: train_lm on the source bytes, one checkpoint, scored
    by the evaluator (EVAL_LM line)."""
    corpus = os.path.join(train_dir, "corpus.bin")
    corpus_bytes = write_source_corpus(corpus)
    t0 = time.perf_counter()
    _run_child("train_lm", _module("train_lm") + [
        "--lm-corpus-file", corpus, *lm_recipe(args.max_steps),
        "--train-dir", train_dir, "--device", args.device],
        args.timeout_s)
    train_s = time.perf_counter() - t0
    ev = _run_child("evaluate", _module("evaluate") + [
        "--train-dir", train_dir, "--once", str(args.max_steps),
        "--device", args.device], args.timeout_s)
    m = re.search(rf"EVAL_LM step (\d+) loss {_FLOAT} perplexity {_FLOAT}",
                  ev.stdout)
    if m is None:
        raise RuntimeError(f"no EVAL_LM line in the evaluator's output: "
                           f"{ev.stdout[-400:]}")
    ppl = float(m.group(3))
    platform, kind = probe_platform(args.device)
    return _emit({
        "metric": "lm_time_to_perplexity",
        "dataset": f"framework source bytes ({corpus_bytes} B)",
        "network": "TransformerLM", "data": "real",
        "steps": int(m.group(1)), "train_wall_s": round(train_s, 1),
        "eval_loss": float(m.group(2)), "perplexity": ppl,
        "target_perplexity": args.target_ppl,
        "met_target": ppl <= args.target_ppl,
        "platform": platform, "device_kind": kind,
        "contract": "train_lm checkpoint -> evaluate --once (EVAL_LM)",
    }, args)


def run(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dataset", default="Digits")
    p.add_argument("--network", default="LeNet")
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--max-steps", type=int, default=1200)
    p.add_argument("--target-prec1", type=float, default=0.98)
    p.add_argument("--lm", action="store_true",
                   help="LM oracle on a real byte corpus (the source tree) "
                        "instead of the CNN/Digits oracle")
    p.add_argument("--target-ppl", type=float, default=16.0)
    p.add_argument("--train-dir", default="./train_dir_accuracy")
    p.add_argument("--out", default="")
    p.add_argument("--timeout-s", type=float, default=1200.0)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    if args.out and Path(args.out).name.startswith("ACCURACY") and \
            Path(args.out).resolve().parent == REPO:
        p.error(f"{args.out} is a JAX artifact's name; write this "
                "harness's elsewhere")
    if args.device == "cuda":
        from ps_pytorch_tpu_torch.runtime.trainer import resolve_device
        resolve_device("cuda")          # no card: raise before any child

    # The children run in the repo: a relative --train-dir means the same
    # directory to the harness and to them.
    train_dir = str(Path(args.train_dir).resolve())
    os.makedirs(train_dir, exist_ok=True)
    if args.lm:
        return run_lm(args, train_dir)
    t0 = time.perf_counter()
    _run_child("train", _module("train") + [
        *cnn_recipe(args), "--train-dir", train_dir, "--device",
        args.device], args.timeout_s)
    train_s = time.perf_counter() - t0
    ev = _run_child("evaluate", _module("evaluate") + [
        "--train-dir", train_dir, "--once", str(args.max_steps),
        "--device", args.device], args.timeout_s)
    m = re.search(rf"EVAL step (\d+) loss {_FLOAT} prec1 {_FLOAT} "
                  rf"prec5 {_FLOAT}", ev.stdout)
    if m is None:
        raise RuntimeError(f"no EVAL line in the evaluator's output: "
                           f"{ev.stdout[-400:]}")
    prec1, prec5 = float(m.group(3)), float(m.group(4))
    platform, kind = probe_platform(args.device)
    return _emit({
        "metric": "time_to_accuracy",
        "dataset": args.dataset, "network": args.network,
        "data": "real",
        "steps": int(m.group(1)), "train_wall_s": round(train_s, 1),
        "eval_loss": float(m.group(2)),
        "prec1": prec1, "prec5": prec5,
        "target_prec1": args.target_prec1,
        "met_target": prec1 >= args.target_prec1,
        "platform": platform, "device_kind": kind,
        "contract": "train checkpoint -> evaluate --once",
    }, args)


def main(argv=None) -> int:
    return 0 if run(argv)["met_target"] else 1


if __name__ == "__main__":
    sys.exit(main())
