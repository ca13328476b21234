#!/usr/bin/env python
"""Grad-codec accuracy sweep: the lossy-compression oracle run. The JAX
package's ``tools/accuracy_codec.py`` (its ``RUNS``, flags, rows and JSONL
artifact) on the port's ``MultiSliceTrainer``.

Trains the SAME async task (LeNet / synthetic_mnist, 2 equal-rate
slices) once per grad codec and
reports each lossy codec's eval-loss/precision delta against the lossless
baseline, with and without sender-side error feedback. This is the
evidence row behind --grad-codec: the wire bench prices the bytes, this
artifact prices the accuracy. The codecs (blosc, int8lat, topk, randk) are
the port's host codecs (``compression/codecs.py``); the slices train on
``--device`` (default ``cuda``; ``cpu`` runs the plain versions).

The baseline is --compress-grad with the lossless blosc codec — the
leader's decode-then-average path the homomorphic family replaces. int8lat
is near-lossless per step (<= 2^-8 relative rounding per leaf);
topk/randk at small --grad-topk-frac drop mass every step and rely on
error feedback to re-send it, so the sweep runs each sparsifier both ways:
the EF-off row shows the raw damage, the EF-on row what the residual
accumulator recovers (arXiv 2103.00543's evaluation shape).

    python -m ps_pytorch_tpu_torch.tools.accuracy_codec --steps 240 \\
        --num-seeds 3 --out /tmp/accuracy_codec.jsonl

The artifact is written only where ``--out`` says, never to the JAX
sweep's ``ACCURACY_CODEC_r13.json``.
"""

import argparse
import json
import os
import sys
import tempfile

ARTIFACT_NOT_WRITTEN = "ACCURACY_CODEC_r13.json"

RUNS = [
    # (label, grad_codec, topk_frac, ef)
    ("baseline_blosc", "blosc", None, False),
    ("int8lat", "int8lat", None, False),
    ("int8lat_ef", "int8lat", None, True),
    ("topk_05", "topk", 0.05, False),
    ("topk_05_ef", "topk", 0.05, True),
    ("randk_05", "randk", 0.05, False),
    ("randk_05_ef", "randk", 0.05, True),
]


def run_one(label: str, codec: str, frac, ef: bool, steps: int,
            eval_batches: int, seeds, device: str = "cuda") -> dict:
    from ps_pytorch_tpu_torch.config import TrainConfig
    from ps_pytorch_tpu_torch.runtime.multislice import MultiSliceTrainer

    per_seed = []
    for seed in seeds:
        with tempfile.TemporaryDirectory(prefix=f"acc_codec_{label}_") as td:
            # lr below the test_multislice convergence setting (0.02): the
            # synthetic task's weak signal is borderline-stable there, and
            # codec noise on an unstable trajectory measures the blow-up,
            # not the codec (the JAX package's
            # test_async_training_reduces_loss lr note). Single-seed deltas on this task are dominated by
            # trajectory noise, hence the multi-seed mean.
            cfg = TrainConfig(
                dataset="synthetic_mnist", network="LeNet", batch_size=256,
                lr=0.01, momentum=0.9, compute_dtype="float32", mode="async",
                max_steps=steps, staleness_limit=4, eval_freq=0,
                log_every=10_000, seed=seed, train_dir=td,
                compress_grad=True, grad_codec=codec,
                grad_topk_frac=frac if frac is not None else 0.01, ef=ef)
            # Equal-rate slices: the mixed-rate [1, 2] schedule is
            # chaotic at this lr (seed-to-seed loss spread > the codec
            # effect being measured — one seed diverges outright), so the
            # sweep isolates codec loss on the stable geometry.
            t = MultiSliceTrainer(cfg, n_slices=2, slice_periods=[1, 1],
                                  device=device, printer=lambda line: None)
            t.train(max_steps=steps)
            per_seed.append(t.evaluate(max_batches=eval_batches))

    def mean(key):
        return sum(float(r[key]) for r in per_seed) / len(per_seed)

    losses = [float(r["loss"]) for r in per_seed]
    mu = mean("loss")
    var = sum((l - mu) ** 2 for l in losses) / len(losses)
    return {"config": label, "grad_codec": codec,
            "topk_frac": frac, "ef": ef, "steps": steps,
            "seeds": list(seeds),
            "eval_loss": round(mu, 6),
            "eval_loss_std": round(var ** 0.5, 6),
            "prec1": round(mean("prec1"), 4),
            "prec5": round(mean("prec5"), 4)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=240)
    p.add_argument("--eval-batches", type=int, default=4)
    p.add_argument("--num-seeds", type=int, default=3,
                   help="average each config over this many seeds (42..)")
    p.add_argument("--out", default="", help="write the JSONL artifact here")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    if os.path.basename(args.out) == ARTIFACT_NOT_WRITTEN:
        p.error(f"{args.out} is the JAX sweep's artifact; write this "
                "sweep's elsewhere")

    seeds = list(range(42, 42 + args.num_seeds))
    rows = []
    base = None
    for label, codec, frac, ef in RUNS:
        row = run_one(label, codec, frac, ef, args.steps, args.eval_batches,
                      seeds, args.device)
        if base is None:
            base = row
        else:
            row["loss_delta_vs_lossless"] = round(
                row["eval_loss"] - base["eval_loss"], 6)
            row["prec5_delta_vs_lossless"] = round(
                row["prec5"] - base["prec5"], 4)
        print(json.dumps(row), flush=True)
        rows.append(row)

    if args.out:
        tmp = f"{args.out}.tmp{os.getpid()}"
        with open(tmp, "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
        os.replace(tmp, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
