#!/usr/bin/env python
"""Peak device memory per feature mode: the JAX package's
``tools/memory_probe.py`` (its modes, child processes, rows and artifact)
on the port's own modules.

ZeRO-1 (``--shard-update``), remat (``--remat``), pipeline microbatching
and flash attention exist to buy memory. Each mode runs in a CHILD process
of its own and reports that process's peak, so no mode reads another's
high-water mark.

Modes
  lm_base / lm_remat          TransformerLM b=8 S=2048 d=512, 8 layers, 8
                              heads, vocab 32000 (the JAX ``LM_GEOM``),
                              full attention, f32: per-block remat drops
                              every block's intermediates (the [B,H,S,S]
                              attention matrix included) from the
                              backward's saved set.
  lm_flash                    the same LM on the hand-written flash kernels
                              (``csrc/flash_attention.cu``, f32 on the
                              tensor cores, 3xTF32): the backward keeps one
                              log-sum-exp row per query instead of the
                              [B,H,S,S] probabilities. The row carries the
                              flash launches the port's wrappers counted.
  lm_pp_m1 / lm_pp_m8         the GPipe step on a one-stage grid in one
                              process: M microbatches slice the activation
                              working set ~M times.
  cnn_base / cnn_remat /      ResNet-18 at batch 1024 through the port's
  cnn_zero1                   train step (bf16, ``conv_impl`` xla, as the
                              JAX ``bench_suite._build``); zero1 on one
                              process is the degenerate case (no other
                              rank to hold a shard), measured all the same.

The peak is ``torch.cuda.max_memory_allocated()`` of the child: the
caching allocator's high-water mark of tensor bytes, under the JAX field
name ``peak_bytes_in_use``. It is not the JAX runtime's figure: XLA's
buffers, fusion and donation differ, so the two packages' peaks are not
one quantity. ``bytes_in_use`` is ``memory_allocated()`` after the steps,
``largest_alloc`` not measured (null). On the CPU a row has no peak and
carries the JAX note.

``--jobs N`` (the port's own flag, default 1 as the JAX tool) runs up to
N children at once: each peak is its own process's, so the peaks do not
change; the rows' ``wall_s`` then share the card.

    python -m ps_pytorch_tpu_torch.tools.memory_probe \\
        --out /tmp/memory.json

The default artifact is ``memory_probe.json`` in the working directory;
the JAX probe's ``MEMORY_r04.json`` is never written.
"""

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from pathlib import Path

import numpy as np

MODES = ("lm_base", "lm_remat", "lm_flash", "lm_pp_m1", "lm_pp_m8",
         "cnn_base", "cnn_remat", "cnn_zero1")

LM_GEOM = dict(batch=8, seq_len=2048, d_model=512, n_layers=8, n_heads=8,
               vocab=32000)

CNN_BATCH = 1024             # the headline geometry
ARTIFACT_NOT_WRITTEN = "MEMORY_r04.json"
REPO = str(Path(__file__).resolve().parents[2])
FLASH_COUNTS = ("flash_fwd", "flash_dq", "flash_dkv")


def lm_tokens() -> np.ndarray:
    """The JAX probe's batch: ``default_rng(0)`` integers in the vocab."""
    g = LM_GEOM
    return np.random.default_rng(0).integers(
        0, g["vocab"], size=(g["batch"], g["seq_len"])).astype(np.int32)


def _lm_step(mode: str, device: str, params=None):
    """The ``tick(i) -> metrics`` of an LM mode. ``params``:
    a flax parameter tree to start from (the tests' JAX weights), else
    the port's seeded init."""
    import torch

    from ps_pytorch_tpu_torch.config import TrainConfig
    from ps_pytorch_tpu_torch.models import convert
    from ps_pytorch_tpu_torch.models.transformer import TransformerLM
    from ps_pytorch_tpu_torch.optim import build_optimizer

    g = LM_GEOM
    cfg = TrainConfig(dataset="synthetic", network="LeNet",
                      batch_size=g["batch"], lr=0.01, momentum=0.9)
    opt = build_optimizer(cfg)
    impl = "flash" if mode.endswith("flash") else "full"
    model = TransformerLM(
        vocab_size=g["vocab"], d_model=g["d_model"], n_layers=g["n_layers"],
        n_heads=g["n_heads"], max_seq_len=g["seq_len"], attention_impl=impl,
        remat=mode.endswith("remat"),
        generator=torch.Generator().manual_seed(0))
    if params is not None:
        model.load_state_dict(convert.from_jax(params))
    model.to(device)
    if mode.startswith("lm_pp"):
        from ps_pytorch_tpu_torch.parallel import pp
        from ps_pytorch_tpu_torch.parallel.mesh import RankGrid

        stage = pp.PipelineStage(model, 0, 1)
        step = pp.PPTrainStep(stage, opt, RankGrid(1, 1, 0),
                              int(mode.rsplit("_m", 1)[1]))
    else:
        from ps_pytorch_tpu_torch.parallel.sp import LMTrainStep
        step = LMTrainStep(model, opt)
    tokens = lm_tokens()
    return lambda i: step(tokens)


def _cnn_step(mode: str, device: str):
    """The ``tick(i) -> metrics`` of a CNN mode: the JAX
    ``bench_suite._build`` of ("ResNet18", "Cifar10", 1024): bf16,
    conv_impl xla, SGD lr 0.1 momentum 0.9 weight decay 1e-4, random
    normal inputs of ``default_rng(0)``, a mask of ones."""
    from ps_pytorch_tpu_torch.config import TrainConfig
    from ps_pytorch_tpu_torch.data.datasets import DATASET_SHAPES
    from ps_pytorch_tpu_torch.models import build_model
    from ps_pytorch_tpu_torch.optim import build_optimizer
    from ps_pytorch_tpu_torch.parallel.dp import make_train_step

    batch = CNN_BATCH
    cfg = TrainConfig(dataset="Cifar10", network="ResNet18",
                      batch_size=batch, lr=0.1, momentum=0.9,
                      weight_decay=1e-4, compute_dtype="bfloat16",
                      remat=mode.endswith("remat"),
                      shard_update=mode.endswith("zero1"), conv_impl="xla")
    model = build_model(cfg.network, cfg.num_classes, cfg.compute_dtype,
                        cfg.conv_impl, seed=0).to(device)
    step = make_train_step(model, build_optimizer(cfg), remat=cfg.remat,
                           shard_update=cfg.shard_update)
    h, w, c, ncls, _ = DATASET_SHAPES[cfg.dataset]
    rng = np.random.default_rng(0)
    # Host arrays: the step uploads its batch, as the trainer's does.
    x = rng.normal(size=(batch, h, w, c)).astype(np.float32)
    y = rng.integers(0, ncls, batch).astype(np.int32)
    mask = np.ones(1, np.float32)
    return lambda i: step(x, y, mask)


def flash_counts() -> dict:
    """The flash wrappers' launches, and ``<name>_tc``: their tensor-core
    kernel's."""
    from ps_pytorch_tpu_torch.ops import flash_attention as fa
    out = {}
    for name in FLASH_COUNTS:
        fn = getattr(fa, name)
        out[name], out[f"{name}_tc"] = fn.launches, fn.tc_launches
    return out


def child_main(mode: str, device: str) -> int:
    import torch

    from ps_pytorch_tpu_torch.runtime.trainer import (
        resolve_device, set_reference_numerics,
    )

    dev = resolve_device(device)
    set_reference_numerics()
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tick = (_lm_step if mode.startswith("lm") else _cnn_step)(mode,
                                                               str(dev))
    before = flash_counts()
    step_s = []
    for i in range(3):
        t1 = time.perf_counter()
        metrics = tick(i)
        loss = float(metrics["loss"])       # waits for the device
        step_s.append(time.perf_counter() - t1)
    if cuda:
        torch.cuda.synchronize()
    out = {
        "mode": mode, "platform": "gpu" if cuda else "cpu",
        "device_kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "peak_bytes_in_use": torch.cuda.max_memory_allocated(dev)
        if cuda else None,
        "bytes_in_use": torch.cuda.memory_allocated(dev) if cuda else None,
        "largest_alloc": None,
        "loss": round(loss, 4),
        "wall_s": round(time.perf_counter() - t0, 1),
        "step_s": [round(s, 4) for s in step_s],
    }
    if mode == "lm_flash":
        after = flash_counts()
        out["flash_launches"] = {k: after[k] - before[k] for k in after}
    if out["peak_bytes_in_use"] is None:
        out["note"] = "backend reports no memory_stats (CPU)"
    print(json.dumps(out))
    return 0


def run_child(mode: str, device: str, timeout: float) -> dict:
    """One mode in a fresh process: its last stdout line, or a row with
    the error (a failure or a timeout is a row, as in the JAX probe)."""
    cmd = [sys.executable, "-m", "ps_pytorch_tpu_torch.tools.memory_probe",
           "--child", mode, "--device", device]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout, cwd=REPO)
        line = (proc.stdout or "").strip().splitlines()
        return (json.loads(line[-1]) if proc.returncode == 0 and line
                else {"mode": mode, "error":
                      (proc.stderr or "no output").strip()[-300:]})
    except subprocess.TimeoutExpired:
        return {"mode": mode, "error": f"timeout {timeout:.0f}s"}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--child", default="", help="internal: run one mode")
    p.add_argument("--modes", default=",".join(MODES))
    p.add_argument("--out", default="memory_probe.json")
    p.add_argument("--timeout", type=float, default=600.0)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--jobs", type=int, default=1,
                   help="children run at once (each peak is its own)")
    args = p.parse_args(argv)
    if args.child:
        return child_main(args.child, args.device)

    # The whole list is checked before any child starts: a typo would
    # otherwise measure the base config under the wrong label.
    modes = [m.strip() for m in args.modes.split(",") if m.strip()]
    bad = [m for m in modes if m not in MODES]
    if bad:
        p.error(f"unknown mode(s) {bad}; valid: {', '.join(MODES)}")
    if os.path.basename(args.out) == ARTIFACT_NOT_WRITTEN:
        p.error(f"{ARTIFACT_NOT_WRITTEN} is the JAX probe's artifact; "
                "write this probe's elsewhere")
    if args.device == "cuda":
        from ps_pytorch_tpu_torch.runtime.trainer import resolve_device
        resolve_device("cuda")          # no card: raise before any child
        if "lm_flash" in modes:
            from ps_pytorch_tpu_torch.ops import _build
            _build.build(["flash_attention"])   # the children load it

    def child(mode):
        return run_child(mode, args.device, args.timeout)

    rows = []
    with ThreadPoolExecutor(args.jobs) if args.jobs > 1 else \
            nullcontext() as pool:
        for row in (pool.map(child, modes) if pool else map(child, modes)):
            print(json.dumps(row), flush=True)
            rows.append(row)
            # The artifact after every row: a run cut at row 6 of 8
            # still leaves one to read.
            _write_doc(args.out, rows)
    _write_doc(args.out, rows, final=True)
    return 0


def _write_doc(out: str, rows, final: bool = False) -> dict:
    """The JAX artifact: the rows, the derived deltas and ``complete``."""
    by = {r["mode"]: r for r in rows}

    def peak(m):
        v = by.get(m, {}).get("peak_bytes_in_use")
        return v if isinstance(v, int) and v > 0 else None

    deltas = {}
    for a, b, key in (("lm_base", "lm_remat", "lm_remat_saves_bytes"),
                      ("lm_pp_m1", "lm_pp_m8", "pp_m8_saves_bytes"),
                      ("cnn_base", "cnn_remat", "cnn_remat_saves_bytes"),
                      ("cnn_base", "cnn_zero1", "cnn_zero1_saves_bytes")):
        if peak(a) and peak(b):
            deltas[key] = peak(a) - peak(b)
    doc = {"rows": rows, "deltas": deltas, "complete": final}
    tmp = out + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1)
    os.replace(tmp, out)
    if final:
        print(json.dumps({"wrote": out, "deltas": deltas}))
    return doc


if __name__ == "__main__":
    sys.exit(main())
