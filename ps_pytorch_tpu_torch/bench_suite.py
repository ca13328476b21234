#!/usr/bin/env python
"""The port's benchmark suite: the JAX package's root ``bench_suite.py``
(its 49 ``CONFIGS`` rows, the derived rows of ``main``, ``--markdown`` and
``--isolate``) on the port's own modules.

Each row keeps the JAX row's name, keys and geometry. One JSON line a
config; ``--markdown`` also writes the BASELINE.md-style table.

- **Chip rows** (the train steps, the LM, decode, serving, the quantizer,
  conv3x3 against ``F.conv2d``, the overhead rows) run on the device
  ``--device`` names, ``cuda`` by default: a missing card raises, and the
  row records the error. ``platform`` is ``"gpu"`` on the card and
  ``"cpu"`` on the CPU, and ``device_kind`` (``torch.cuda.get_device_name``)
  is the one key the JAX rows lack. A row whose kernels launched carries
  ``launches``: each hand-written kernel's launches during the row
  (``<name>_tc``: conv3x3's and flash's tensor-core kernel), counted by
  the wrappers. On the CPU the wrappers run their plain versions and
  count nothing, so the row has no ``launches``.
- **Host rows** (the loader, the wire, the codecs, the hierarchy, the
  quorum KV, ZeRO over the wire) keep ``"platform": "host"``. Their wire
  is byte for byte the JAX one: ``payload_sha256``, ``wire_mb``,
  ``params_sha256`` and ``bitwise_identical`` equal the JAX rows' for the
  same seed and geometry.

The JAX suite spans ``len(jax.devices())``; the port spans the ranks
of a launch, one process a replica (``tools/launch.py``), ``--ranks N``
of them (default: the cards the host shows, or 1 with ``--device cpu``):

- **Rows over the ranks** (:data:`SPANNING`: the train-step rows whose
  JAX counterpart spans the devices, and the LM rows without a pinned
  attention) run as one launch of N rank processes, each on
  ``cuda:{rank % cards}``, over NCCL when each rank has a card of its own
  and gloo when they share one (``parallel/dist.py``). Rank r takes rows
  ``[r*per, (r+1)*per)`` of the JAX global batch (drawn from
  ``default_rng(0)`` at ``per * N``: the data axis's shard), the step
  all-reduces over the default group, the mask is the JAX ``_build``'s
  over N (K-of-N zeroes the ranks past ``num_aggregate``) and
  ``shard_update`` shards over the ranks. ``transformer_lm_2k`` and its
  remat twin run ring attention over the ranks (``parallel/sp.py``),
  ``moe_lm_2k`` its experts over them (``parallel/ep.py``). A row's
  seconds are the slowest rank's mean (an all-reduce MAX); rank 0 alone
  writes it, with ``devices`` N, ``backend`` and, for a train step, the
  ``mask``, every rank's ``rank_launches`` and ``rank_params_sha256``
  (equal on every rank: one update on every replica).
- **Rows in one process**: ``lenet_mnist_single`` and the rows of pinned
  attention on one device, the loader rows at the JAX global batch (per
  device times N), ``resnet18_async_2slice`` over N devices in one
  ``MultiSliceTrainer`` (a slice count that does not divide N falls to
  one slice, the JAX rule), and every host row.

At one rank a spanning row runs in the suite's own process, with no
group (``backend`` ``none``). Started under the env contract (by
``tools.launch`` with ``--entry ps_pytorch_tpu_torch.bench_suite``), the
suite joins that group instead: the spanning rows run on every rank, the
others on rank 0 alone, and every rank ends with a ``FINAL`` line. A
rank whose spanning row fails raises, and the launch ends the fleet.
Every timed loop ends in ``torch.cuda.synchronize()`` (and, for a step,
reading its loss) before the clock is read.

    python -m ps_pytorch_tpu_torch.bench_suite --configs int8_quantizer
    python -m ps_pytorch_tpu_torch.bench_suite --ranks 4 \\
        --configs vgg11_cifar100_kofn,resnet18_zero1,moe_lm_2k
    python -m ps_pytorch_tpu_torch.bench_suite --device cpu \\
        --configs wire_blocking_8mb,wire_overlapped_8mb --steps 2

Usage: [--configs a,b] [--steps 20] [--device cuda|cpu] [--ranks N]
[--isolate] [--row-timeout S] [--markdown PATH].
"""

import argparse
import hashlib
import json
import os
import time
from contextlib import nullcontext
from pathlib import Path
from typing import Optional

import numpy as np
import torch

REPO = str(Path(__file__).resolve().parents[1])

# The device of the chip rows (``--device``); every bench function also
# takes ``device=`` for one call.
DEVICE = "cuda"
# The world the rows span: ``--ranks``, or the group of the launch this
# process joined. The JAX suite's ``len(jax.devices())``.
DEVICES = 1

# The rows that run on every rank of a launch.
SPANNING = frozenset({
    "lenet_mnist_dp", "resnet18_cifar10_dp", "vgg11_cifar100_kofn",
    "resnet50_imagenet", "resnet18_fused_sgd", "resnet18_zero1",
    "resnet18_remat", "resnet18_b2048", "resnet18_b4096",
    "transformer_lm_2k", "transformer_lm_2k_remat", "moe_lm_2k",
    "resnet18_pallas_conv", "vgg11_pallas_conv", "lenet_convergence"})

# Effective reference rates (images/sec), the JAX suite's estimates
# (BASELINE.md): a single m4.2xlarge ~80 img/s on ResNet-18, LeNet ~1,245
# img/s, scaled by the published speedups; none published for VGG /
# CIFAR-100 or ResNet-50 / ImageNet.
BASELINES = {
    "lenet_mnist_single": 1245.0,
    "lenet_mnist_dp": 1245.0 * 5.59,
    "resnet18_cifar10_dp": 80.0 * 5.19,
    "vgg11_cifar100_kofn": None,
    "resnet50_imagenet": None,
}

# Wrappers that count their launches, and those that count their
# tensor-core kernel's apart (``tc_launches``).
TC_COUNTED = ("conv3x3", "flash_fwd", "flash_dq", "flash_dkv")


# ----------------------------------------------------------- the device

def _device(device: Optional[str] = None) -> torch.device:
    """The row's device: this rank's card in a launch."""
    from ps_pytorch_tpu_torch.parallel import dist
    from ps_pytorch_tpu_torch.runtime.trainer import resolve_device
    return dist.local_device(str(resolve_device(device or DEVICE)))


def _chip(dev: torch.device) -> dict:
    """A chip row's ``platform`` and ``device_kind``."""
    if dev.type == "cuda":
        return {"platform": "gpu",
                "device_kind": torch.cuda.get_device_name(dev)}
    return {"platform": dev.type, "device_kind": dev.type}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _row_group(n: int):
    """The group a row over ``n`` replicas runs on: the launch's default
    group when ``n`` is its world, none for one replica alone."""
    from ps_pytorch_tpu_torch.parallel import dist
    if n == DEVICES:
        return dist.group()
    if n == 1:
        return None
    raise ValueError(f"n_devices={n} in a world of {DEVICES}: run the "
                     f"suite with --ranks {n} (one process a rank, "
                     "tools/launch.py)")


def _backend(group) -> str:
    return torch.distributed.get_backend(group) if group is not None \
        else "none"


def _slowest(seconds: float, group, dev: torch.device) -> float:
    """The largest of every rank's ``seconds`` (one all-reduce MAX): the
    step of a synchronous group is its slowest rank's."""
    if group is None:
        return seconds
    on = dev if _backend(group) == "nccl" else "cpu"
    t = torch.tensor([seconds], dtype=torch.float64, device=on)
    torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MAX,
                                 group=group)
    return float(t[0])


def _params_sha256(model: torch.nn.Module) -> str:
    h = hashlib.sha256()
    for p in model.parameters():
        h.update(p.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def _with_ranks(row: dict, before: dict, group, model=None,
                mask=None) -> dict:
    """``row`` with ``launches`` (this rank's), ``backend`` and, for a
    train step, its ``mask``; in a group also every rank's launches and
    parameter sha256, in rank order (a collective: every rank calls
    it)."""
    row = _with_launches(row, before)
    row["backend"] = _backend(group)
    if mask is not None:
        row["mask"] = [int(m) for m in mask]
    if group is not None:
        mine = {"launches": row.get("launches", {}),
                "params_sha256": (_params_sha256(model) if model is not None
                                  else None)}
        every = [None] * torch.distributed.get_world_size(group)
        torch.distributed.all_gather_object(every, mine, group=group)
        row["rank_launches"] = [r["launches"] for r in every]
        if model is not None:
            row["rank_params_sha256"] = [r["params_sha256"] for r in every]
    return row


def kernel_wrappers() -> dict:
    """Every hand-written kernel's wrapper, by its name in the kernels
    line of ``chip_smoke.py``."""
    from ps_pytorch_tpu_torch.ops import conv3x3 as conv_mod
    from ps_pytorch_tpu_torch.ops import flash_attention as fa
    from ps_pytorch_tpu_torch.ops import fused_adam as adam_mod
    from ps_pytorch_tpu_torch.ops import fused_sgd as sgd_mod
    from ps_pytorch_tpu_torch.ops import quantize as tq
    return {"conv3x3": conv_mod.conv3x3,
            "fused_sgd": sgd_mod.fused_sgd_update,
            "fused_adam": adam_mod.fused_adam_update,
            "flash_fwd": fa.flash_fwd, "flash_dq": fa.flash_dq,
            "flash_dkv": fa.flash_dkv, "quantize": tq.quantize_int8}


def kernel_counts() -> dict:
    """Launches so far of every wrapper, and ``<name>_tc`` of the
    tensor-core kernels."""
    wrappers = kernel_wrappers()
    counts = {name: fn.launches for name, fn in wrappers.items()}
    for name in TC_COUNTED:
        counts[f"{name}_tc"] = wrappers[name].tc_launches
    return counts


def _with_launches(row: dict, before: dict) -> dict:
    """``row`` plus ``launches``: the counts that moved since ``before``
    (none on the CPU, where the wrappers run their plain versions)."""
    after = kernel_counts()
    moved = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    if moved:
        row["launches"] = moved
    return row


# ------------------------------------------------------------ the steps

def _build(network, dataset, batch, *, mode="sync", num_aggregate=0,
           n_devices=None, dtype="bfloat16", fused=False, remat=False,
           shard_update=False, lr=0.1, conv_impl="xla", device=None):
    """(model, step, x, y, mask) of the JAX ``_build`` over ``n_devices``
    replicas (default: the world): the port's ``TrainConfig``,
    ``build_model`` (seed 0), ``build_optimizer`` and
    ``parallel/dp.make_train_step`` (``parallel/zero`` under
    ``shard_update``) on the row's group; the global batch of ``batch``
    from ``default_rng(0)``, of which this rank's rows (the data axis's
    shard) go to its device once; a mask of ones over the replicas
    (K-of-N's zeros past ``num_aggregate``)."""
    from ps_pytorch_tpu_torch.config import TrainConfig
    from ps_pytorch_tpu_torch.data.datasets import DATASET_SHAPES
    from ps_pytorch_tpu_torch.models import build_model
    from ps_pytorch_tpu_torch.optim import build_optimizer
    from ps_pytorch_tpu_torch.parallel.dp import make_train_step
    from ps_pytorch_tpu_torch.runtime.trainer import set_reference_numerics

    n = n_devices or DEVICES
    group = _row_group(n)
    if batch % n:
        raise ValueError(f"global batch {batch} over {n} replicas")
    rank = torch.distributed.get_rank(group) if group is not None else 0
    per = batch // n
    dev = _device(device)
    set_reference_numerics()
    cfg = TrainConfig(dataset=dataset, network=network, batch_size=batch,
                      lr=lr, momentum=0.9, weight_decay=1e-4,
                      compute_dtype=dtype, mode=mode,
                      num_aggregate=num_aggregate, fused_optimizer=fused,
                      remat=remat, shard_update=shard_update,
                      conv_impl=conv_impl)
    model = build_model(cfg.network, cfg.num_classes, cfg.compute_dtype,
                        cfg.conv_impl, seed=0).to(dev)
    step = make_train_step(model, build_optimizer(cfg), group=group,
                           remat=remat, shard_update=shard_update)
    h, w, c, ncls, _ = DATASET_SHAPES[dataset]
    rng = np.random.default_rng(0)
    rows = slice(rank * per, (rank + 1) * per)
    x = torch.as_tensor(rng.normal(size=(batch, h, w, c))
                        .astype(np.float32)[rows]).to(dev)
    y = torch.as_tensor(rng.integers(0, ncls, batch).astype(np.int32)
                        [rows]).to(dev)
    mask = np.ones(n, np.float32)
    if mode == "kofn" and 0 < num_aggregate < n:
        mask[num_aggregate:] = 0.0
    return model, step, x, y, mask


def time_steps(state, step_fn, x, y, mask, steps=20, warmup=3, tracer=None):
    """Mean seconds a step (a float: ``bench.py`` reads it). ``state`` is
    the model the step updates in place. ``tracer``: a telemetry Tracer;
    the timed loop's dispatch and final sync become its spans."""
    def span(name, i):
        return (tracer.span(name, step=i) if tracer is not None
                else nullcontext())

    dev = step_fn.device
    for i in range(warmup):
        metrics = step_fn(x, y, mask, i)
    _ = float(metrics["loss"])
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(steps):
        with span("host_dispatch", i + 1):
            metrics = step_fn(x, y, mask, 100 + i)
    with span("device_sync", steps):
        _sync(dev)
        _ = float(metrics["loss"])
    return (time.perf_counter() - t0) / steps


def bench_throughput(name, network, dataset, per_device_batch, steps, **kw):
    from ps_pytorch_tpu_torch.telemetry import Tracer

    n_dev = kw.pop("n_devices", None) or DEVICES
    batch = per_device_batch * n_dev
    before = kernel_counts()
    state, step_fn, x, y, mask = _build(network, dataset, batch,
                                        n_devices=n_dev, **kw)
    tracer = Tracer()
    sec_per_step = _slowest(
        time_steps(state, step_fn, x, y, mask, steps=steps, tracer=tracer),
        step_fn.group, step_fn.device)
    ips = batch / sec_per_step
    base = BASELINES.get(name)
    return _with_ranks({
        "config": name, "network": network, "dataset": dataset,
        **_chip(step_fn.device), "devices": n_dev, "global_batch": batch,
        "sec_per_step": round(sec_per_step, 5),
        "images_per_sec": round(ips, 1),
        "phases": tracer.totals(),
        "vs_baseline": round(ips / base, 2) if base else None,
        # The reference published only relative speedups: vs_baseline is
        # derived from estimates (BASELINES), not from a measurement.
        "vs_baseline_basis": "estimate" if base else None},
        before, step_fn.group, state, mask)


def bench_input_pipeline(name, dataset, per_device_batch, steps, workers=1):
    """Loader-only throughput at the headline batch: the augmentation
    stack and prefetch, no device in the loop (host rows: the ratio row
    in ``main`` pairs it with the chip row's demand). ``workers`` drives
    the loader's assembly pool (0: one a CPU)."""
    from ps_pytorch_tpu_torch.config import TrainConfig
    from ps_pytorch_tpu_torch.data.augment import (
        CROP_STACKS, RRC_STACKS, input_norm_for, norm_constants_for,
    )
    from ps_pytorch_tpu_torch.data.datasets import DataLoader, load_arrays

    batch = per_device_batch * DEVICES
    cfg = TrainConfig(dataset=dataset, network="ResNet18", batch_size=batch)
    dev_norm = input_norm_for(cfg) is not None
    x, y = load_arrays(cfg.dataset, cfg.data_dir, train=True, seed=0)
    loader = DataLoader(x, y, batch, cfg.dataset, train=True, seed=0,
                        device_normalize=dev_norm, workers=workers)
    xb, _ = loader.next_batch()     # warms the prefetch thread
    t0 = time.perf_counter()
    n_img = 0
    for _ in range(steps):
        xb, _ = loader.next_batch()
        n_img += len(xb)
    dt = time.perf_counter() - t0
    ips = n_img / dt
    if dataset in RRC_STACKS:
        stack = f"rrc{xb.shape[1]}x{xb.shape[2]}+flip"
    elif dataset in CROP_STACKS:
        stack = "pad4+crop+flip"
    else:
        stack = "shuffle+batch"
    if not dev_norm and norm_constants_for(dataset) is not None:
        stack += "+normalize"
    return {"config": name, "dataset": dataset, "global_batch": batch,
            "platform": "host",
            "loader_images_per_sec": round(ips, 1),
            # Bandwidth of the shipped batches, not the stored array.
            "bytes_per_sec_mb": round(ips * xb.nbytes / len(xb) / 1e6, 1),
            "augment": stack,
            "loader_workers": loader.workers,
            "device_normalize": dev_norm}


def bench_quantizer(name, steps, device=None):
    """The int8 quantizer kernel (``csrc/quantize.cu``, its noise drawn in
    the kernel) on a VGG-11-sized gradient vector: pipelined and blocking
    ms a call, the dequantize, the shrink and the round trip's error."""
    from ps_pytorch_tpu_torch.ops.quantize import (
        dequantize_int8, quantize_tree, quantized_nbytes,
    )

    dev = _device(device)
    before = kernel_counts()
    n = 9_231_114          # VGG-11 (CIFAR head) parameter count
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(n,)).astype(np.float32)).to(dev)

    def quantize(i):
        return quantize_tree([x], key=(0, i % 32))[0]

    q = quantize(0)
    y = dequantize_int8(q)
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(steps):
        q = quantize(i)
    _sync(dev)
    dt_q = (time.perf_counter() - t0) / steps
    # Blocking latency a call beside the pipelined throughput.
    t0 = time.perf_counter()
    for i in range(min(steps, 5)):
        q = quantize(i)
        _sync(dev)
    dt_block = (time.perf_counter() - t0) / min(steps, 5)
    t0 = time.perf_counter()
    for _ in range(steps):
        y = dequantize_int8(q)
    _sync(dev)
    dt_d = (time.perf_counter() - t0) / steps
    nbytes = n * 4
    err = float((y - x).abs().max())
    return _with_launches({
        "config": name, "tensor_bytes": nbytes,
        "wire_bytes": quantized_nbytes(q),
        "shrink": round(nbytes / quantized_nbytes(q), 2),
        "quantize_ms": round(dt_q * 1e3, 3),
        "quantize_blocking_ms": round(dt_block * 1e3, 3),
        "dequantize_ms": round(dt_d * 1e3, 3),
        "quantize_gbps": round(nbytes / dt_q / 1e9, 1),
        "max_abs_err": round(err, 5), **_chip(dev)}, before)


def bench_async_multislice(name, steps, *, network="ResNet18",
                           dataset="synthetic", per_slice_batch=512,
                           n_slices=2, device=None):
    """Async (stale-gradient) throughput: the in-process
    ``MultiSliceTrainer`` over the world's devices (the JAX trainer's
    ``jax.devices()``: on the card ``cuda:{i % cards}`` for i < N), its
    canonical state on the first. The JAX rule: a slice count that does
    not divide the devices falls to one slice."""
    from ps_pytorch_tpu_torch.config import TrainConfig
    from ps_pytorch_tpu_torch.runtime.multislice import MultiSliceTrainer

    n = DEVICES
    if n % n_slices:
        n_slices = 1
    dev = _device(device)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    devices = [torch.device("cuda", i % cards) if cards else dev
               for i in range(n)]
    before = kernel_counts()
    cfg = TrainConfig(dataset=dataset, network=network,
                      batch_size=per_slice_batch, lr=0.1, momentum=0.9,
                      weight_decay=1e-4, mode="async", max_steps=10 ** 9,
                      eval_freq=0, log_every=10 ** 9)
    t = MultiSliceTrainer(cfg, n_slices=n_slices, devices=devices,
                          device=str(devices[0]))
    for _ in range(3):          # build + warm
        t.tick()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        t.tick()
    _sync(dev)
    dt = (time.perf_counter() - t0) / steps
    imgs = per_slice_batch * n_slices
    return _with_launches({
        "config": name, "network": network, **_chip(dev), "devices": n,
        "n_slices": n_slices, "per_slice_batch": per_slice_batch,
        "sec_per_tick": round(dt, 5),
        "images_per_sec": round(imgs / dt, 1),
        "applied": t.applied, "dropped_stale": t.dropped_stale,
        "pool_wire_bytes": t.aggregator.wire_bytes()}, before)


def _lm_tokens(vocab, batch, seq_len) -> np.ndarray:
    return np.random.default_rng(0).integers(
        0, vocab, size=(batch, seq_len)).astype(np.int32)


def _lm_opt():
    from ps_pytorch_tpu_torch.config import TrainConfig
    from ps_pytorch_tpu_torch.optim import build_optimizer
    return build_optimizer(TrainConfig(dataset="synthetic", network="LeNet",
                                       batch_size=8, lr=0.01, momentum=0.9))


def _timed_steps(step, tokens, steps, dev):
    """Three warm-up steps, then the mean seconds of ``steps``; -> (s,
    the last metrics)."""
    for _ in range(3):
        m = step(tokens)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        m = step(tokens)
    _sync(dev)
    return (time.perf_counter() - t0) / steps, m


def bench_transformer_lm(name, steps, *, batch=8, seq_len=2048, d_model=512,
                         n_layers=8, n_heads=8, vocab=32000, remat=False,
                         attention=None, device=None):
    """TransformerLM training throughput (tokens a second), f32, SGD lr
    0.01 momentum 0.9. The JAX row's rule: an ``attention`` given
    (``flash``: the hand-written kernels) pins the row to one device;
    without one the sequence is sharded over the world's ranks with ring
    attention (``parallel/sp.py``), and one device runs ``full``."""
    from ps_pytorch_tpu_torch.models.transformer import TransformerLM
    from ps_pytorch_tpu_torch.parallel.mesh import make_grid
    from ps_pytorch_tpu_torch.parallel.sp import LMTrainStep, sequence_shard
    from ps_pytorch_tpu_torch.runtime.trainer import set_reference_numerics

    n = 1 if attention is not None else DEVICES
    group = _row_group(n)
    axis = make_grid(data=n, model=1).data if n > 1 else None
    dev = _device(device)
    set_reference_numerics()
    before = kernel_counts()
    impl = attention or ("ring" if n > 1 else "full")
    model = TransformerLM(vocab_size=vocab, d_model=d_model,
                          n_layers=n_layers, n_heads=n_heads,
                          max_seq_len=seq_len, attention_impl=impl,
                          remat=remat, axis=axis,
                          generator=torch.Generator().manual_seed(0)).to(dev)
    step = LMTrainStep(model, _lm_opt(), axis)
    tokens = sequence_shard(_lm_tokens(vocab, batch, seq_len), axis)
    dt, m = _timed_steps(step, tokens, steps, dev)
    dt = _slowest(dt, group, dev)
    return _with_ranks({
        "config": name, "attention": impl, **_chip(dev),
        "devices": n, "batch": batch, "seq_len": seq_len,
        "d_model": d_model, "n_layers": n_layers, "remat": remat,
        "sec_per_step": round(dt, 5),
        "tokens_per_sec": round(batch * seq_len / dt, 1),
        "loss": round(float(m["loss"]), 4)}, before, group, model)


def bench_moe_lm(name, steps, *, batch=8, seq_len=2048, d_model=512,
                 n_layers=8, n_heads=8, vocab=32000, n_experts=8,
                 device=None):
    """The MoE (switch top-1) LM at the dense row's geometry, its experts
    over the world's ranks (``parallel/ep.py``), each rank a dispatch
    group of its rows of the batch; the expert count rounds up to a
    multiple of the ranks, as in the JAX suite."""
    from ps_pytorch_tpu_torch.models.moe import MoETransformerLM
    from ps_pytorch_tpu_torch.parallel import ep
    from ps_pytorch_tpu_torch.parallel.mesh import Axis, make_grid
    from ps_pytorch_tpu_torch.parallel.tp import batch_shard
    from ps_pytorch_tpu_torch.runtime.trainer import set_reference_numerics

    n = DEVICES
    group = _row_group(n)
    axis = (make_grid(data=n, model=1).data if n > 1
            else Axis("data", [0], 0, None))
    dev = _device(device)
    set_reference_numerics()
    before = kernel_counts()
    e = -(-n_experts // n) * n
    model = MoETransformerLM(vocab_size=vocab, d_model=d_model,
                             n_layers=n_layers, n_heads=n_heads,
                             n_experts=e, max_seq_len=seq_len,
                             generator=torch.Generator().manual_seed(0))
    model = ep.shard_model_(model.to(dev), axis)
    step = ep.EPTrainStep(model, _lm_opt(), axis)
    tokens = batch_shard(_lm_tokens(vocab, batch, seq_len), axis)
    dt, m = _timed_steps(step, tokens, steps, dev)
    dt = _slowest(dt, group, dev)
    return _with_ranks({
        "config": name, **_chip(dev), "devices": n, "batch": batch,
        "seq_len": seq_len, "d_model": d_model, "n_layers": n_layers,
        "n_experts": e, "sec_per_step": round(dt, 5),
        "tokens_per_sec": round(batch * seq_len / dt, 1),
        "loss": round(float(m["loss"]), 4),
        "aux": round(float(m["aux"]), 4)}, before, group)


def bench_lm_decode(name, steps, *, batch=1, prompt_len=128, n_new=128,
                    d_model=512, n_layers=8, n_heads=8, vocab=32000,
                    max_seq_len=2048, device=None):
    """Decode throughput of the k/v-cache generator
    (``models/generate.py``): ``n_new=1`` (prefill and one sample) and
    ``n_new=1+N`` timed ``steps`` times each; their difference over N is
    a token's decode cost."""
    from ps_pytorch_tpu_torch.models.generate import generate
    from ps_pytorch_tpu_torch.models.transformer import TransformerLM

    dev = _device(device)
    before = kernel_counts()
    model = TransformerLM(vocab_size=vocab, d_model=d_model,
                          n_layers=n_layers, n_heads=n_heads,
                          max_seq_len=max_seq_len, attention_impl="full",
                          generator=torch.Generator().manual_seed(0)).to(dev)
    # The generator uploads its prompt, as a request's.
    prompt = np.random.default_rng(0).integers(0, vocab, (batch, prompt_len))
    kw = dict(temperature=1.0, top_k=40, seed=0)

    def timed(n):
        generate(model, prompt, n_new=n, **kw)
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(steps):
            generate(model, prompt, n_new=n, **kw)
            _sync(dev)
        return (time.perf_counter() - t0) / steps

    t_prefill = timed(1)
    t_full = timed(1 + n_new)
    per_tok = (t_full - t_prefill) / n_new
    return _with_launches({
        "config": name, **_chip(dev), "batch": batch,
        "prompt_len": prompt_len, "n_new": n_new, "d_model": d_model,
        "n_layers": n_layers, "vocab": vocab,
        "prefill_plus1_s": round(t_prefill, 5),
        "sec_per_token": round(per_tok, 6),
        "decode_tokens_per_sec": round(batch / per_tok, 1)
        if per_tok > 0 else None,
        "end_to_end_tokens_per_sec": round(batch * (1 + n_new) / t_full,
                                           1)}, before)


def _served_model(vocab, d_model, n_layers, n_heads, seq_len, dev):
    from ps_pytorch_tpu_torch.models.transformer import TransformerLM
    return TransformerLM(vocab_size=vocab, d_model=d_model,
                         n_layers=n_layers, n_heads=n_heads,
                         max_seq_len=seq_len,
                         generator=torch.Generator().manual_seed(0)).to(dev)


def _tokens_sha256(reqs) -> str:
    import hashlib
    return hashlib.sha256(json.dumps(
        [r.tokens for r in reqs]).encode()).hexdigest()


def bench_serving(name, steps, *, slots, n_req=8, prompt_len=32, n_new=64,
                  d_model=128, n_layers=2, n_heads=4, vocab=256,
                  seq_len=256, device=None):
    """Continuous-batching throughput (``serving/``): ``n_req`` seeded
    requests drained closed-loop through a ``slots``-wide engine; slots=1
    is the sequential baseline. ``tokens_sha256`` hashes every request's
    tokens in request order: ``main`` holds the batched and sequential
    hashes equal."""
    from ps_pytorch_tpu_torch.serving.engine import ServingEngine
    from ps_pytorch_tpu_torch.serving.loadgen import (
        make_requests, run_closed_loop,
    )

    dev = _device(device)
    model = _served_model(vocab, d_model, n_layers, n_heads, seq_len, dev)
    engine = ServingEngine(model, slots=slots)
    # Warm-up on another seed base: the timed loop measures decode.
    run_closed_loop(engine, make_requests(min(slots, 2),
                                          prompt_len=prompt_len, n_new=4,
                                          vocab=vocab, seed=9999))
    reqs = make_requests(n_req, prompt_len=prompt_len, n_new=n_new,
                         vocab=vocab, seed=123)
    stats = run_closed_loop(engine, reqs)
    return {"config": name, **_chip(dev),
            "slots": slots, "n_req": n_req, "prompt_len": prompt_len,
            "n_new": n_new, "d_model": d_model, "n_layers": n_layers,
            "vocab": vocab,
            "completed": stats["completed"], "tokens": stats["tokens"],
            "wall_s": round(stats["wall_s"], 4),
            "tokens_per_sec": round(stats["tokens_per_sec"], 1),
            "ttft_p50_ms": round(stats["ttft_p50_ms"], 2),
            "ttft_p99_ms": round(stats["ttft_p99_ms"], 2),
            "latency_p50_ms": round(stats["latency_p50_ms"], 2),
            "latency_p99_ms": round(stats["latency_p99_ms"], 2),
            "tokens_sha256": _tokens_sha256(reqs)}


def bench_slo_sweep(name, steps, *, slots=4, n_req=10, prompt_len=16,
                    n_new=24, d_model=64, n_layers=2, n_heads=2, vocab=128,
                    seq_len=64,
                    slo_spec="ttft_p99<30s;latency_p99<60s;"
                             "availability>=99",
                    rates=(1.0, 2.0, 4.0, 8.0), device=None):
    """Goodput under an SLO: a rising Poisson ladder through the open-loop
    path, each rung judged against ``slo_spec``; the knee is the highest
    compliant rate. ``knee_bar`` is the lowest offered rate (the regress
    ``slo`` family gates ``knee_rps >= knee_bar``). ``steps`` is unused."""
    from ps_pytorch_tpu_torch.serving.engine import ServingEngine
    from ps_pytorch_tpu_torch.serving.loadgen import (
        make_requests, run_closed_loop, run_slo_sweep,
    )

    dev = _device(device)
    engine = ServingEngine(_served_model(vocab, d_model, n_layers, n_heads,
                                         seq_len, dev), slots=slots)
    run_closed_loop(engine, make_requests(
        min(slots, 2), prompt_len=prompt_len, n_new=4, vocab=vocab,
        seed=9999))
    sweep = run_slo_sweep(engine, slo_spec, rates=rates, n_req=n_req,
                          prompt_len=prompt_len, n_new=n_new, seed=321)
    knee_bar = min(rates)
    ladder = [{k: r.get(k) for k in
               ("rate_rps", "completed", "shed", "rejected", "failed",
                "tokens_per_sec", "ttft_p99_ms", "latency_p99_ms",
                "availability")} | {"compliant": r["slo"]["compliant"]}
              for r in sweep["ladder"]]
    return {"config": name, **_chip(dev),
            "slots": slots, "n_req_per_rung": n_req, "n_new": n_new,
            "slo_spec": slo_spec, "ladder": ladder,
            "knee_rps": sweep["knee_rps"],
            "goodput_under_slo_tps": sweep["goodput_under_slo_tps"],
            "knee_bar": knee_bar,
            "ok": bool(sweep["ok"] and sweep["knee_rps"] is not None
                       and sweep["knee_rps"] >= knee_bar)}


def bench_reqtrace_overhead(name, steps, *, reps=3, slots=8, n_req=8,
                            prompt_len=32, n_new=64, d_model=128,
                            n_layers=2, n_heads=4, vocab=256, seq_len=256,
                            device=None):
    """The request plane's cost: ``serve_batched_8``'s workload through a
    bare engine and through one with the serving registry, the
    RequestTraceLog ring and an SLOTracker; min of ``reps`` each. ``ok``
    needs the <2% budget and bitwise-identical tokens."""
    from ps_pytorch_tpu_torch.serving.engine import ServingEngine
    from ps_pytorch_tpu_torch.serving.loadgen import (
        make_requests, run_closed_loop,
    )
    from ps_pytorch_tpu_torch.serving.reqtrace import RequestTraceLog
    from ps_pytorch_tpu_torch.telemetry import (
        Registry, declare_serving_metrics,
    )
    from ps_pytorch_tpu_torch.telemetry.slo import SLOTracker

    dev = _device(device)
    model = _served_model(vocab, d_model, n_layers, n_heads, seq_len, dev)

    def run(traced):
        kw = {}
        if traced:
            registry = declare_serving_metrics(Registry())
            kw = dict(registry=registry,
                      reqtrace=RequestTraceLog(256, sample=0.05),
                      slo=SLOTracker("ttft_p99<30s;latency_p99<60s;"
                                     "availability>=99", registry=registry))
        engine = ServingEngine(model, slots=slots, **kw)
        run_closed_loop(engine, make_requests(
            min(slots, 2), prompt_len=prompt_len, n_new=4, vocab=vocab,
            seed=9999))
        best, sha = None, None
        for _ in range(reps):
            reqs = make_requests(n_req, prompt_len=prompt_len, n_new=n_new,
                                 vocab=vocab, seed=123)
            stats = run_closed_loop(engine, reqs)
            if best is None or stats["wall_s"] < best:
                best = stats["wall_s"]
            if sha is None:
                sha = _tokens_sha256(reqs)
        return best, sha

    baseline_s, sha_bare = run(False)
    traced_s, sha_traced = run(True)
    frac = (traced_s - baseline_s) / baseline_s
    bitwise = sha_bare == sha_traced
    return {"config": name, **_chip(dev),
            "slots": slots, "n_req": n_req, "n_new": n_new, "reps": reps,
            "baseline_s": round(baseline_s, 5),
            "traced_s": round(traced_s, 5),
            "overhead_frac": round(frac, 5),
            "bitwise_identical": bitwise,
            "ok": bool(bitwise and frac < 0.02)}


def bench_pallas_conv_ab(name, steps, *, batch=1024, hw=32, c=64,
                         device=None):
    """A/B: the hand-written conv3x3 (``csrc/conv3x3.cu``, the tensor-core
    kernel in bf16) against ``F.conv2d`` (cuDNN) at the JAX row's
    geometry, forward and input gradient (``torch.nn.grad.conv2d_input``:
    one call, as the JAX baseline's transposed program). ``accepted_*``
    are decided here, by ratio, and only on the card; off it the row
    shrinks to a smoke run, as the JAX row does off the TPU.

    ``variants`` keeps the JAX keys ``taps9`` and ``im2col``, each timed:
    they name two MXU schedules of the TPU kernel, and the port's wrapper
    takes ``variant`` for the JAX signature only, both running the same
    kernel. ``block_n``, the TPU kernel's batch tile, has no counterpart
    and is recorded as null."""
    import torch.nn.functional as F

    from ps_pytorch_tpu_torch.ops.conv3x3 import conv3x3, conv3x3_input_grad

    dev = _device(device)
    on_card = dev.type == "cuda"
    if not on_card:
        batch, steps = 64, min(steps, 3)    # plain-version smoke only
    before = kernel_counts()
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(batch, hw, hw, c))).to(
        dev, torch.bfloat16)
    w = torch.as_tensor(rng.normal(size=(3, 3, c, c)) * 0.1).to(
        dev, torch.bfloat16)
    # NCHW views of the NHWC data (channels-last memory) and OIHW of HWIO.
    x_nchw = x.permute(0, 3, 1, 2)
    w_oihw = w.permute(3, 2, 0, 1)

    def xla_conv():
        return F.conv2d(x_nchw, w_oihw, padding=1)

    def xla_bwd():                      # x reused as the cotangent
        return torch.nn.grad.conv2d_input(x_nchw.shape, w_oihw, x_nchw,
                                          padding=1)

    def timed(fn):
        fn()
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        _sync(dev)
        return (time.perf_counter() - t0) / steps

    t_xla = timed(xla_conv)
    t_xla_bwd = timed(xla_bwd)
    raw = {v: (timed(lambda v=v: conv3x3(x, w, v)),
               timed(lambda v=v: conv3x3_input_grad(x, w, v)))
           for v in ("taps9", "im2col")}
    # Ratios from raw seconds; the rounding is for display.
    t_pl = min(f for f, _ in raw.values())
    t_pl_bwd = min(b for _, b in raw.values())
    variants = {v: {"fwd_ms": round(f * 1e3, 3),
                    "grad_input_ms": round(b * 1e3, 3), "block_n": None}
                for v, (f, b) in raw.items()}
    flops = 2 * batch * hw * hw * c * c * 9
    ratio = t_xla / t_pl
    ratio_bwd = t_xla_bwd / t_pl_bwd
    return _with_launches({
        "config": name, **_chip(dev), "batch": batch,
        "hw": hw, "channels": c, "block_n": None,
        "xla_ms": round(t_xla * 1e3, 3),
        "pallas_ms": round(t_pl * 1e3, 3),
        "xla_grad_input_ms": round(t_xla_bwd * 1e3, 3),
        "pallas_grad_input_ms": round(t_pl_bwd * 1e3, 3),
        "variants": variants,
        "xla_tflops": round(flops / t_xla / 1e12, 1),
        "pallas_tflops": round(flops / t_pl / 1e12, 1),
        "speedup_vs_xla": round(ratio, 3),
        "speedup_vs_xla_bwd": round(ratio_bwd, 3),
        "accepted_fwd": bool(on_card and ratio > 1.05),
        "accepted_bwd": bool(on_card and ratio_bwd > 1.05),
        "accepted": bool(on_card and (ratio > 1.05 or ratio_bwd > 1.05))},
        before)


def bench_time_to_loss(name, network, dataset, batch, target_loss,
                       max_steps=400, device=None):
    """Convergence probe: wall time to a training loss on a learnable
    synthetic task, in f32 (TF32 off) at lr 0.02, the loss read every
    step so the step count is exact; ``batch`` is the global batch over
    the world's replicas, whose loss, all-reduced, ends every rank's loop
    at the same step."""
    state, step_fn, x, y, mask = _build(network, dataset, batch,
                                        dtype="float32", lr=0.02,
                                        device=device)
    m = step_fn(x, y, mask, 0)          # warm-up outside the clock
    _sync(step_fn.device)
    t0 = time.perf_counter()
    for i in range(max_steps):
        m = step_fn(x, y, mask, 1 + i)
        if float(m["loss"]) <= target_loss:
            break
    loss = float(m["loss"])
    dt = _slowest(time.perf_counter() - t0, step_fn.group, step_fn.device)
    return {"config": name, "network": network, "dataset": dataset,
            **_chip(step_fn.device), "devices": step_fn.world,
            "backend": _backend(step_fn.group),
            "target_loss": target_loss, "reached_loss": round(loss, 4),
            "steps": i + 1, "seconds": round(dt, 3),
            "converged": loss <= target_loss}


class LatencyKV:
    """In-process KV with a fixed service time an op: the network model of
    the wire benches. ``time.sleep`` releases the GIL, so overlapping
    these waits with encode and decode on worker threads is the
    concurrency an RPC in flight gives. ``classes``: ``(key_prefix,
    rtt_s)`` pairs, first match wins, ``rtt_s`` otherwise (the two-tier
    link model of the hierarchy bench)."""

    def __init__(self, inner, rtt_s: float, classes=None):
        self.inner = inner
        self.rtt_s = rtt_s
        self.classes = list(classes or [])
        self.ops = 0

    def _wait(self, key=""):
        self.ops += 1
        rtt = self.rtt_s
        for prefix, class_rtt in self.classes:
            if key.startswith(prefix):
                rtt = class_rtt
                break
        if rtt > 0:
            time.sleep(rtt)

    def set(self, key, value):
        self._wait(key)
        self.inner.set(key, value)

    def get(self, key, default=None):
        self._wait(key)
        return self.inner.get(key, default)

    def delete(self, key):
        self._wait(key)
        self.inner.delete(key)

    def keys(self, prefix=""):
        self._wait(prefix)
        return self.inner.keys(prefix)


def _wire_tree(payload_mb, leaf_kb, seed, count=None):
    """(n_leaves, the JAX benches' payload): leaves ``l0000``... of
    ``default_rng(seed).normal / 4`` in f32; ``count`` trees drawn in turn
    from one generator."""
    n_leaves = max(int(payload_mb * 1024 // leaf_kb), 1)
    per_leaf = int(leaf_kb * 1024 // 4)
    rng = np.random.default_rng(seed)

    def tree():
        return {f"l{i:04d}": rng.normal(size=(per_leaf,))
                .astype(np.float32) / 4.0 for i in range(n_leaves)}

    return n_leaves, (tree() if count is None
                      else [tree() for _ in range(count)])


def _trace_spans(trace_out, run) -> None:
    """``run()`` under a Tracer as the default; its spans as JSON lines."""
    from ps_pytorch_tpu_torch.telemetry import Tracer, set_default_tracer

    tracer = Tracer(pid=0)
    prev = set_default_tracer(tracer)
    try:
        run()
    finally:
        set_default_tracer(prev)
    with open(trace_out, "w") as f:
        for s in tracer.spans():
            f.write(json.dumps(s) + "\n")


def bench_wire(name, steps, *, payload_mb=64, leaf_kb=1024, codec="blosc",
               bucket_mb=4.0, workers=4, rtt_ms=2.0, trace_out=""):
    """Wire microbench: one writer channel publishes a ``payload_mb``
    tree, one reader reads it back, over a LatencyKV; bucket_mb=0 with
    workers=0 is the blocking wire. ``payload_sha256`` hashes the
    armoured chunks in key order."""
    import hashlib

    from ps_pytorch_tpu_torch.parallel.transport import KVPytreeChannel
    from ps_pytorch_tpu_torch.runtime.coordinator import KVStore

    n_leaves, tree = _wire_tree(payload_mb, leaf_kb, 0)
    bucket_bytes = int(bucket_mb * (1 << 20))

    def channels(kv):
        return [KVPytreeChannel(kv, "bench/wire", tree, codec=codec,
                                bucket_bytes=bucket_bytes, workers=workers)
                for _ in range(2)]

    publish_s = read_s = 0.0
    sha = payload_bytes = buckets = None
    reps = max(steps, 1)
    for rep in range(reps):
        kv = LatencyKV(KVStore(), rtt_ms / 1e3)
        writer, reader = channels(kv)
        t0 = time.perf_counter()
        writer.publish(1, tree)
        t1 = time.perf_counter()
        got = reader.read()
        t2 = time.perf_counter()
        assert got is not None and got[0] == 1
        publish_s += t1 - t0
        read_s += t2 - t1
        if rep == 0:
            for k in tree:
                np.testing.assert_array_equal(np.asarray(got[1][k]),
                                              tree[k])
            # The armoured payload in key order, off the backing dict.
            h = hashlib.sha256()
            meta = json.loads(kv.inner.get("bench/wire/1/meta"))
            for l_idx, n in enumerate(meta["chunks"]):
                for c_idx in range(n):
                    h.update(kv.inner.get(f"bench/wire/1/{l_idx}/{c_idx}")
                             .encode("ascii"))
            sha = h.hexdigest()
            payload_bytes = writer.last_publish_bytes
            buckets = len(writer.last_publish_bucket_bytes)
    row = {"config": name, "platform": "host", "payload_mb": payload_mb,
           "leaves": n_leaves, "codec": codec, "bucket_mb": bucket_mb,
           "workers": workers, "rtt_ms": rtt_ms, "buckets": buckets,
           "wire_mb": round(payload_bytes / 1e6, 2),
           "publish_s": round(publish_s / reps, 3),
           "read_s": round(read_s / reps, 3),
           "total_s": round((publish_s + read_s) / reps, 3),
           "steps": reps, "payload_sha256": sha}
    if trace_out:
        def traced():
            writer, reader = channels(LatencyKV(KVStore(), rtt_ms / 1e3))
            writer.publish(1, tree)
            reader.read()
        _trace_spans(trace_out, traced)
    return row


def bench_codec_agg(name, steps, *, codec="int8lat", payload_mb=24,
                    leaf_kb=1024, contributors=4, frac=0.01, rtt_ms=2.0,
                    bucket_mb=4.0, workers=4, trace_out=""):
    """The gradient wire and the leader's aggregation for one grad codec:
    ``contributors`` senders publish a ``payload_mb`` gradient tree over
    the LatencyKV and the leader reads and aggregates them. blosc is the
    decode-then-average baseline; the homomorphic codecs ship payloads
    that the leader sums in the compressed domain. ``bitwise_identical``
    holds the homomorphic average against the decode-then-average oracle
    over the same payloads."""
    from ps_pytorch_tpu_torch.compression.codecs import (
        HOMOMORPHIC_GRAD_CODECS, decode_then_average, encode_leaves,
        is_payload)
    from ps_pytorch_tpu_torch.parallel.async_dp import (
        StaleGradientAggregator, tree_flatten, tree_unflatten,
    )
    from ps_pytorch_tpu_torch.parallel.transport import KVPytreeChannel
    from ps_pytorch_tpu_torch.runtime.coordinator import KVStore

    homomorphic = codec in HOMOMORPHIC_GRAD_CODECS
    n_leaves, trees = _wire_tree(payload_mb, leaf_kb, 7, contributors)
    leaves0, treedef = tree_flatten(trees[0])
    raw_bytes = contributors * sum(l.nbytes for l in leaves0)
    bucket_bytes = int(bucket_mb * (1 << 20))
    if homomorphic:
        template = tree_unflatten(treedef, encode_leaves(
            codec, [np.zeros_like(l) for l in leaves0],
            slice_id=0, step=0, frac=frac))
    else:
        template = trees[0]

    def channel(kv, w):
        return KVPytreeChannel(kv, f"bench/agg/{w}", template, codec="blosc",
                               bucket_bytes=bucket_bytes, workers=workers)

    encode_s = publish_s = read_s = agg_s = 0.0
    wire_bytes = bitwise = rel_err = None
    reps = max(min(steps, 3), 1)
    for rep in range(reps):
        kv = LatencyKV(KVStore(), rtt_ms / 1e3)
        writers = [channel(kv, w) for w in range(contributors)]
        readers = [channel(kv, w) for w in range(contributors)]
        # Sender side: the homomorphic codecs encode before the wire; the
        # blosc baseline compresses inside publish().
        t0 = time.perf_counter()
        if homomorphic:
            wire_trees = [tree_unflatten(treedef, encode_leaves(
                codec, tree_flatten(t)[0], slice_id=w, step=rep, frac=frac))
                for w, t in enumerate(trees)]
        else:
            wire_trees = trees
        t1 = time.perf_counter()
        for w, tree in enumerate(wire_trees):
            writers[w].publish(rep + 1, tree)
        t2 = time.perf_counter()
        got = [r.read() for r in readers]
        t3 = time.perf_counter()
        assert all(g is not None and g[0] == rep + 1 for g in got)
        # Leader side: this codec's collect().
        agg = StaleGradientAggregator(
            contributors, staleness_limit=4, num_aggregate=0,
            compress=homomorphic, codec=codec if homomorphic else "blosc",
            topk_frac=frac)
        t4 = time.perf_counter()
        for w, (_, tree, _meta) in enumerate(got):
            if homomorphic:
                agg.submit_encoded(w, rep + 1, tree)
            else:
                agg.submit(w, rep + 1, tree)
        avg, _info = agg.collect(rep + 1)
        t5 = time.perf_counter()
        encode_s += t1 - t0
        publish_s += t2 - t1
        read_s += t3 - t2
        agg_s += t5 - t4
        if rep == 0:
            wire_bytes = sum(w.last_publish_bytes for w in writers)
            avg_leaves = [np.asarray(l) for l in tree_flatten(avg)[0]]
            true_mean = [np.mean([t[k] for t in trees], axis=0)
                         for k in sorted(trees[0])]
            num = sum(float(np.sum((a - m) ** 2))
                      for a, m in zip(avg_leaves, true_mean))
            den = sum(float(np.sum(m ** 2)) for m in true_mean)
            rel_err = round((num / max(den, 1e-30)) ** 0.5, 6)
            if homomorphic:
                # Decode every contribution and average in float: the
                # compressed-domain sum must equal it bitwise.
                oracle = decode_then_average(
                    codec, [(1.0, tree_flatten(got[w][1],
                                               is_leaf=is_payload)[0])
                            for w in range(contributors)])
                oracle = [np.asarray(o).reshape(a.shape)
                          for o, a in zip(oracle, avg_leaves)]
                bitwise = all(np.array_equal(a, o)
                              for a, o in zip(avg_leaves, oracle))
    row = {"config": name, "platform": "host", "grad_codec": codec,
           "contributors": contributors, "payload_mb": payload_mb,
           "leaves": n_leaves, "frac": frac if homomorphic else None,
           "rtt_ms": rtt_ms, "bucket_mb": bucket_mb, "workers": workers,
           "raw_mb": round(raw_bytes / 1e6, 2),
           "wire_mb": round(wire_bytes / 1e6, 2),
           "wire_ratio": round(raw_bytes / max(wire_bytes, 1), 2),
           "encode_s": round(encode_s / reps, 3),
           "publish_s": round(publish_s / reps, 3),
           "read_s": round(read_s / reps, 3),
           "agg_s": round(agg_s / reps, 4),
           "total_s": round((encode_s + publish_s + read_s + agg_s)
                            / reps, 3),
           "agg_rel_err": rel_err, "bitwise_identical": bitwise,
           "steps": reps}
    if trace_out:
        _trace_spans(trace_out, lambda: channel(
            LatencyKV(KVStore(), rtt_ms / 1e3), 0).publish(1,
                                                           wire_trees[0]))
    return row


def bench_hier_agg(name, steps, *, codec="int8lat", payload_mb=8,
                   leaf_kb=512, n_slices=4, group_size=2, frac=0.01,
                   intra_rtt_ms=1.0, inter_rtt_ms=30.0):
    """Flat star against the two-tier hierarchy (``parallel/hierarchy.py``)
    over a link model of two latencies: intra-group keys a fast link,
    everything crossing regions a slow one. Flat ships ``n_slices``
    payloads over the slow link, the hierarchy ``n_groups`` re-encoded
    group aggregates. ``rel_err`` holds the hierarchy's average against
    the flat one (the re-encode may round to the codec's lattice)."""
    from ps_pytorch_tpu_torch.compression.codecs import encode_leaves, is_payload
    from ps_pytorch_tpu_torch.parallel.async_dp import (
        StaleGradientAggregator, tree_flatten, tree_unflatten,
    )
    from ps_pytorch_tpu_torch.parallel.hierarchy import (
        GroupAggregator, HierarchyPlan, RootAggregator,
    )
    from ps_pytorch_tpu_torch.parallel.transport import KVPytreeChannel
    from ps_pytorch_tpu_torch.runtime.coordinator import KVStore

    plan = HierarchyPlan(n_slices, group_size)
    _, trees = _wire_tree(payload_mb, leaf_kb, 11, n_slices)
    leaves0, treedef = tree_flatten(trees[0])
    template = tree_unflatten(treedef, encode_leaves(
        codec, [np.zeros_like(l) for l in leaves0],
        slice_id=0, step=0, frac=frac))
    wire_trees = [tree_unflatten(treedef, encode_leaves(
        codec, tree_flatten(t)[0], slice_id=w, step=1, frac=frac))
        for w, t in enumerate(trees)]
    classes = [("bench/hgrad/", intra_rtt_ms / 1e3)]

    def clock_kv():
        # Everything not intra-group (the flat star's legs and the
        # hierarchy's up-links) crosses regions at the slow RTT.
        return LatencyKV(KVStore(), inter_rtt_ms / 1e3, classes=classes)

    def channel(kv, prefix):
        return KVPytreeChannel(kv, prefix, template, codec="blosc")

    flat_s = hier_s = 0.0
    flat_avg = hier_avg = None
    flat_slow = hier_slow = None
    reps = max(min(steps, 3), 1)
    for rep in range(reps):
        # Flat star: n_slices payloads over the slow link.
        kv = clock_kv()
        t0 = time.perf_counter()
        for w, tree in enumerate(wire_trees):
            channel(kv, f"bench/flat/{w}").publish(1, tree)
        agg = StaleGradientAggregator(n_slices, staleness_limit=4,
                                      num_aggregate=0, compress=True,
                                      codec=codec, topk_frac=frac)
        for w in range(n_slices):
            agg.submit_encoded(w, 1, channel(kv, f"bench/flat/{w}")
                               .read()[1])
        avg, _ = agg.collect(1)
        flat_s += time.perf_counter() - t0
        if rep == 0:
            flat_avg = [np.asarray(l) for l in tree_flatten(avg)[0]]
            flat_slow = kv.ops

        # Two tiers: members on the fast link, one re-encoded payload a
        # group across regions.
        kv = clock_kv()
        t0 = time.perf_counter()
        for w, tree in enumerate(wire_trees):
            gid = plan.group_of(w)
            channel(kv, f"bench/hgrad/{gid}/{w}").publish(1, tree)
        root = RootAggregator(plan.n_groups, codec, staleness_limit=4)
        for gid in range(plan.n_groups):
            ga = GroupAggregator(plan, gid, codec, staleness_limit=4,
                                 topk_frac=frac)
            for sid in plan.members(gid):
                ga.submit_encoded(sid, 1, channel(
                    kv, f"bench/hgrad/{gid}/{sid}").read()[1])
            _step, wsum, up = ga.collect_and_reencode(1)
            channel(kv, f"bench/hagg/{gid}").publish(
                1, up, meta={"wsum": wsum})
        for gid in range(plan.n_groups):
            got = channel(kv, f"bench/hagg/{gid}").read()
            root.submit_group(gid, 1, float(got[2]["wsum"]), got[1])
        avg, _ = root.collect(1)
        hier_s += time.perf_counter() - t0
        if rep == 0:
            hier_avg = [np.asarray(l) for l in
                        tree_flatten(avg, is_leaf=is_payload)[0]]
            hier_slow = kv.ops
    num = sum(float(np.sum((h.reshape(f.shape) - f) ** 2))
              for h, f in zip(hier_avg, flat_avg))
    den = sum(float(np.sum(f ** 2)) for f in flat_avg)
    rel_err = round((num / max(den, 1e-30)) ** 0.5, 6)
    return {"config": name, "platform": "host", "grad_codec": codec,
            "n_slices": n_slices, "group_size": plan.group_size,
            "n_groups": plan.n_groups, "payload_mb": payload_mb,
            "intra_rtt_ms": intra_rtt_ms, "inter_rtt_ms": inter_rtt_ms,
            "flat_s": round(flat_s / reps, 3),
            "hier_s": round(hier_s / reps, 3),
            "speedup": round(flat_s / max(hier_s, 1e-9), 3),
            "flat_kv_ops": flat_slow, "hier_kv_ops": hier_slow,
            "rel_err": rel_err, "steps": reps}


def _bare_and_with(run, reps):
    """min of ``reps`` runs of ``run(False)``, then of ``run(True)``."""
    return (min(run(False) for _ in range(reps)),
            min(run(True) for _ in range(reps)))


def _overhead_row(name, dev, steps, reps, batch, baseline_s, with_s, key,
                  **extra):
    frac = (with_s - baseline_s) / baseline_s
    return {"config": name, **_chip(dev),
            "steps": steps, "reps": reps, "global_batch": batch, **extra,
            "baseline_s": round(baseline_s, 5), key: round(with_s, 5),
            "overhead_frac": round(frac, 5), "ok": frac < 0.02}


def _lenet_seconds(batch, steps, device, work=None) -> float:
    """The overhead rows' loop: a fresh ``_build("LeNet",
    "synthetic_mnist", batch)`` step (the same seed every time), three
    warm-up steps, then the seconds of ``steps`` steps, each reading its
    loss and then calling ``work(i, loss, t0)``."""
    _, step_fn, x, y, mask = _build("LeNet", "synthetic_mnist", batch,
                                    n_devices=1, device=device)
    for i in range(3):
        step_fn(x, y, mask, i)
    _sync(step_fn.device)
    t0 = time.perf_counter()
    for i in range(steps):
        loss = float(step_fn(x, y, mask, 100 + i)["loss"])
        if work is not None:
            work(i, loss, t0)
    _sync(step_fn.device)
    return time.perf_counter() - t0


def bench_ops_overhead(name, steps, *, batch=256, reps=3, device=None):
    """The ops plane's cost: the LeNet step loop bare and with the live
    ops work of every step (the running /metrics exporter, registry
    updates, the health watchdogs, a flight-recorder record). Both loops
    read the loss; min of ``reps`` each; the budget is <2%."""
    import tempfile

    from ps_pytorch_tpu_torch.telemetry import (
        FlightRecorder, HealthMonitor, MetricsExporter, Registry,
        declare_training_metrics, host_rss_bytes,
    )

    dev = _device(device)

    def run(ops) -> float:
        registry = declare_training_metrics(Registry())
        health = HealthMonitor("nonfinite:warn;spike:warn;divergence:warn",
                               registry=registry)
        tmp = tempfile.mkdtemp(prefix="bench_ops_")
        flightrec = FlightRecorder(os.path.join(tmp, "flightrec.json"),
                                   registry=registry)
        exporter = MetricsExporter(registry).start() if ops else None
        prev = {}

        def work(i, loss, t0):
            t_step = time.perf_counter() - prev.get("t", t0)
            registry.inc("train_steps")
            registry.set("train_step", float(i + 1))
            registry.set("train_loss", loss)
            registry.set("train_step_time_s", t_step)
            registry.observe("train_step_latency_s", t_step)
            registry.set("host_rss_bytes", float(host_rss_bytes()))
            flightrec.record_step(i + 1, loss=loss, step_time=t_step)
            health.observe_step(i + 1, loss=loss, nonfinite=False,
                                step_time=t_step)
            prev["t"] = time.perf_counter()

        try:
            return _lenet_seconds(batch, steps, dev, work if ops else None)
        finally:
            if exporter is not None:
                exporter.stop()

    baseline_s, ops_s = _bare_and_with(run, reps)
    return _overhead_row(name, dev, steps, reps, batch, baseline_s, ops_s,
                         "ops_s")


def bench_integrity_overhead(name, steps, *, batch=256, reps=3,
                             device=None):
    """The gradient-integrity plane's cost: the LeNet step loop bare and
    with the per-step work the async leader adds: the wire digests of
    every armoured chunk on both sides (stamp and verify, 4
    contributors) and the compressed-domain screen over one 4-contributor
    round of LeNet-gradient-shaped int8lat payloads (the JAX tree's
    leaves, in its order). Encoding and armouring are outside the delta.
    The budget is <2%."""
    from ps_pytorch_tpu_torch.compression.codecs import encode_leaves
    from ps_pytorch_tpu_torch.models import build_model, convert
    from ps_pytorch_tpu_torch.parallel.async_dp import tree_flatten
    from ps_pytorch_tpu_torch.parallel.transport import _encode_leaf
    from ps_pytorch_tpu_torch.resilience.integrity import (
        GradIntegrity, verify_digest, wire_digest,
    )

    dev = _device(device)
    params, _ = convert.to_jax(build_model("LeNet").state_dict())
    rng = np.random.default_rng(0)
    grad_leaves = [rng.standard_normal(l.shape).astype(np.float32) * 0.01
                   for l in tree_flatten(params)[0]]
    contribs, chunks = [], []
    for sid in range(4):
        payloads = encode_leaves("int8lat", grad_leaves, slice_id=sid,
                                 step=0)
        contribs.append((sid, payloads))
        chunks.append([c for p in payloads
                       for c in _encode_leaf(p, 3, "blosc")])
    wire_chunks = sum(len(c) for c in chunks)

    def run(integrity) -> float:
        gi = GradIntegrity() if integrity else None

        def work(i, _loss, _t0):
            for sid_chunks in chunks:
                toks = [wire_digest(c) for c in sid_chunks]
                assert all(verify_digest(c, t)
                           for c, t in zip(sid_chunks, toks))
            admitted, _ = gi.screen(contribs, step=i)
            assert len(admitted) == 4

        return _lenet_seconds(batch, steps, dev, work if integrity else None)

    baseline_s, integrity_s = _bare_and_with(run, reps)
    return _overhead_row(name, dev, steps, reps, batch, baseline_s,
                         integrity_s, "integrity_s", contributors=4,
                         wire_chunks=wire_chunks)


def bench_elastic_overhead(name, steps, *, batch=256, reps=3, device=None):
    """The elastic control plane's cost when no fault fires: the LeNet
    step loop bare and with a heartbeat, the lease refresh (one write an
    interval), the membership recompute and the epoch and world gauges
    every step, over an in-process KVStore. The budget is <2%."""
    from ps_pytorch_tpu_torch import elastic as elx
    from ps_pytorch_tpu_torch.runtime.coordinator import KVStore
    from ps_pytorch_tpu_torch.telemetry import (
        Registry, declare_elastic_metrics, declare_training_metrics,
    )

    dev = _device(device)

    def run(elastic) -> float:
        registry = declare_training_metrics(Registry())
        if not elastic:
            return _lenet_seconds(batch, steps, dev)
        declare_elastic_metrics(registry)
        kv = KVStore()
        election = elx.LeaderElection(kv, "bench", 0, 1, interval_s=1.0)
        announcer = elx.MemberAnnouncer(kv, "bench", 0, [0], interval_s=1.0)
        membership = elx.MembershipRegistry(kv, "bench", 1, 1)
        election.claim_initial()
        announcer.join()

        def work(i, _loss, _t0):
            announcer.beat(i + 1)
            election.refresh(i + 1)
            membership.update(i + 1)
            registry.set("leader_epoch", float(election.epoch))
            registry.set("world_size", float(len(membership.members) or 1))

        return _lenet_seconds(batch, steps, dev, work)

    baseline_s, elastic_s = _bare_and_with(run, reps)
    return _overhead_row(name, dev, steps, reps, batch, baseline_s,
                         elastic_s, "elastic_s")


def bench_kvrep_overhead(name, steps, *, payload_mb=24, leaf_kb=1024,
                         codec="blosc", bucket_mb=4.0, workers=4,
                         rtt_ms=2.0, n_backends=3, reps=5):
    """Quorum replication's cost (``runtime/kvrep.py``): the wire bench's
    publish and read over one LatencyKV and over a ReplicatedKV of
    ``n_backends`` of them at the same RTT; min of ``reps`` each, the
    payload held equal on both. The budget is <5%."""
    from ps_pytorch_tpu_torch.parallel.transport import KVPytreeChannel
    from ps_pytorch_tpu_torch.runtime.coordinator import KVStore
    from ps_pytorch_tpu_torch.runtime.kvrep import ReplicatedKV

    rtt_s = rtt_ms / 1e3
    n_leaves, tree = _wire_tree(payload_mb, leaf_kb, 0)
    bucket_bytes = int(bucket_mb * (1 << 20))

    def run(kv) -> float:
        writer, reader = [KVPytreeChannel(
            kv, "bench/kvrep", tree, codec=codec, bucket_bytes=bucket_bytes,
            workers=workers) for _ in range(2)]
        t0 = time.perf_counter()
        writer.publish(1, tree)
        got = reader.read()
        dt = time.perf_counter() - t0
        assert got is not None and got[0] == 1
        for k in tree:
            np.testing.assert_array_equal(np.asarray(got[1][k]), tree[k])
        return dt

    single_s = min(run(LatencyKV(KVStore(), rtt_s)) for _ in range(reps))
    replicated_s = min(
        run(ReplicatedKV([LatencyKV(KVStore(), rtt_s)
                          for _ in range(n_backends)], writer="bench"))
        for _ in range(reps))
    frac = (replicated_s - single_s) / single_s
    return {"config": name, "platform": "host", "payload_mb": payload_mb,
            "leaves": n_leaves, "codec": codec, "bucket_mb": bucket_mb,
            "workers": workers, "rtt_ms": rtt_ms, "n_backends": n_backends,
            "reps": reps, "single_s": round(single_s, 5),
            "replicated_s": round(replicated_s, 5),
            "overhead_frac": round(frac, 5), "ok": frac < 0.05}


def bench_zero(name, steps, *, n_shards=2, payload_mb=24, leaf_kb=1024,
               optimizer="sgd", workers=4, rtt_ms=2.0):
    """ZeRO over the wire (``parallel/zero_wire.py``): ``n_shards``
    single-shard owners drive one gradient stream over one LatencyKV;
    n_shards=1 is the replicated baseline. The row records the bytes a
    replica publishes and reads, the walls, the optimizer state a replica
    and the sha256 of the assembled parameters (``main`` holds the
    sharded runs bitwise the replicated one)."""
    import hashlib

    from ps_pytorch_tpu_torch.parallel.zero_wire import ZeroWireUpdater
    from ps_pytorch_tpu_torch.runtime.coordinator import KVStore

    n_leaves, tree = _wire_tree(payload_mb, leaf_kb, 0)
    opt_kw = dict(lr=0.05, momentum=0.9) if optimizer == "sgd" \
        else dict(lr=1e-3)
    kv = LatencyKV(KVStore(), rtt_ms / 1e3)
    members = list(range(n_shards))
    ups = [ZeroWireUpdater(inner=None, kv=kv, run_id="bench/zw", params=tree,
                           optimizer=optimizer, members=members, me=m,
                           n_shards=n_shards, workers=workers, **opt_kw)
           for m in members]
    rounds = max(min(steps, 5), 2)
    publish_s = assemble_s = 0.0
    grng = np.random.default_rng(1)
    full = None
    for rnd in range(rounds):
        g = {k: grng.normal(size=v.shape).astype(np.float32) / 8.0
             for k, v in tree.items()}
        t0 = time.perf_counter()
        for u in ups:                   # each member: update + publish 1/N
            u.apply_and_publish(g, version=rnd + 1)
        t1 = time.perf_counter()
        trees = [u.assemble_round() for u in ups]
        assemble_s += time.perf_counter() - t1
        publish_s += t1 - t0
        full = trees[0]
    h = hashlib.sha256()
    for k in sorted(full):
        h.update(np.ascontiguousarray(np.asarray(full[k]),
                                      np.float32).tobytes())
    out_mb = [u.wire_stats()["zw_bytes_out"] / 1e6 for u in ups]
    in_mb = [u.wire_stats()["zw_bytes_in"] / 1e6 for u in ups]
    opt_mb = [u.opt_state_nbytes() / 1e6 for u in ups]
    return {"config": name, "platform": "host", "payload_mb": payload_mb,
            "leaves": n_leaves, "optimizer": optimizer, "shards": n_shards,
            "workers": workers, "rtt_ms": rtt_ms, "rounds": rounds,
            "wire_out_mb_max": round(max(out_mb), 3),
            "wire_out_mb_mean": round(sum(out_mb) / len(out_mb), 3),
            "wire_in_mb_max": round(max(in_mb), 3),
            "publish_s": round(publish_s / rounds, 4),
            "assemble_s": round(assemble_s / rounds, 4),
            "total_s": round((publish_s + assemble_s) / rounds, 4),
            "opt_state_mb_max": round(max(opt_mb), 3),
            "params_sha256": h.hexdigest()}


CONFIGS = {
    "lenet_mnist_single": lambda steps: bench_throughput(
        "lenet_mnist_single", "LeNet", "synthetic_mnist", 128, steps,
        n_devices=1),
    "lenet_mnist_dp": lambda steps: bench_throughput(
        "lenet_mnist_dp", "LeNet", "synthetic_mnist", 1024, steps),
    "resnet18_cifar10_dp": lambda steps: bench_throughput(
        "resnet18_cifar10_dp", "ResNet18", "synthetic", 1024, steps),
    "vgg11_cifar100_kofn": lambda steps: bench_throughput(
        "vgg11_cifar100_kofn", "VGG11", "synthetic_cifar100", 256, steps,
        mode="kofn", num_aggregate=max(DEVICES - 1, 1)),
    "resnet50_imagenet": lambda steps: bench_throughput(
        "resnet50_imagenet", "ResNet50_ImageNet", "synthetic_imagenet", 32,
        steps),
    # One feature toggled on the headline task a row.
    "resnet18_fused_sgd": lambda steps: bench_throughput(
        "resnet18_fused_sgd", "ResNet18", "synthetic", 1024, steps,
        fused=True),
    "resnet18_zero1": lambda steps: bench_throughput(
        "resnet18_zero1", "ResNet18", "synthetic", 1024, steps,
        shard_update=True),
    "resnet18_remat": lambda steps: bench_throughput(
        "resnet18_remat", "ResNet18", "synthetic", 1024, steps, remat=True),
    "resnet18_b2048": lambda steps: bench_throughput(
        "resnet18_b2048", "ResNet18", "synthetic", 2048, steps),
    "resnet18_b4096": lambda steps: bench_throughput(
        "resnet18_b4096", "ResNet18", "synthetic", 4096, steps),
    "int8_quantizer": lambda steps: bench_quantizer("int8_quantizer", steps),
    "resnet18_async_2slice": lambda steps: bench_async_multislice(
        "resnet18_async_2slice", steps),
    "transformer_lm_2k": lambda steps: bench_transformer_lm(
        "transformer_lm_2k", steps),
    "transformer_lm_2k_remat": lambda steps: bench_transformer_lm(
        "transformer_lm_2k_remat", steps, remat=True),
    # The flash kernels at the same geometry.
    "transformer_lm_2k_flash": lambda steps: bench_transformer_lm(
        "transformer_lm_2k_flash", steps, attention="flash"),
    # One card at S 8192 on the flash kernels.
    "transformer_lm_8k_flash": lambda steps: bench_transformer_lm(
        "transformer_lm_8k_flash", steps, batch=1, seq_len=8192,
        attention="flash"),
    "moe_lm_2k": lambda steps: bench_moe_lm("moe_lm_2k", steps),
    # Decode at batch 1 (latency) and 32 (batched sampling).
    "lm_decode_b1": lambda steps: bench_lm_decode(
        "lm_decode_b1", min(steps, 5)),
    "lm_decode_b32": lambda steps: bench_lm_decode(
        "lm_decode_b32", min(steps, 5), batch=32),
    "pallas_conv_ab": lambda steps: bench_pallas_conv_ab(
        "pallas_conv_ab", steps),
    # The headline step with every stride-1 3x3 on the hand-written
    # kernel (forward and input gradient; dW in torch ops).
    "resnet18_pallas_conv": lambda steps: bench_throughput(
        "resnet18_pallas_conv", "ResNet18", "synthetic", 1024, steps,
        conv_impl="pallas"),
    "vgg11_pallas_conv": lambda steps: bench_throughput(
        "vgg11_pallas_conv", "VGG11", "synthetic_cifar100", 256, steps,
        mode="kofn", num_aggregate=max(DEVICES - 1, 1),
        conv_impl="pallas"),
    "lenet_convergence": lambda steps: bench_time_to_loss(
        "lenet_convergence", "LeNet", "synthetic_mnist", 512,
        target_loss=0.8),
    "input_pipeline": lambda steps: bench_input_pipeline(
        "input_pipeline", "synthetic_cifar10", 1024, steps),
    "input_pipeline_imagenet": lambda steps: bench_input_pipeline(
        "input_pipeline_imagenet", "synthetic_imagenet", 32, steps),
    # The ImageNet train path: RRC through the worker pool (0: one a CPU).
    "input_pipeline_imagenet_augmented": lambda steps: bench_input_pipeline(
        "input_pipeline_imagenet_augmented", "synthetic_imagenet_rrc", 32,
        steps, workers=0),
    # The blocking and the overlapped wire at one payload, codec and RTT.
    "wire_blocking_8mb": lambda steps: bench_wire(
        "wire_blocking_8mb", min(steps, 5), payload_mb=8,
        bucket_mb=0, workers=0),
    "wire_overlapped_8mb": lambda steps: bench_wire(
        "wire_overlapped_8mb", min(steps, 5), payload_mb=8,
        bucket_mb=2, workers=4),
    "wire_blocking_24mb": lambda steps: bench_wire(
        "wire_blocking_24mb", min(steps, 4), payload_mb=24,
        bucket_mb=0, workers=0),
    "wire_overlapped_24mb": lambda steps: bench_wire(
        "wire_overlapped_24mb", min(steps, 4), payload_mb=24,
        bucket_mb=4, workers=4),
    "wire_blocking_64mb": lambda steps: bench_wire(
        "wire_blocking_64mb", min(steps, 3), payload_mb=64,
        bucket_mb=0, workers=0),
    "wire_overlapped_64mb": lambda steps: bench_wire(
        "wire_overlapped_64mb", min(steps, 3), payload_mb=64,
        bucket_mb=4, workers=4),
    # The homomorphic codecs against blosc's decode-then-average.
    "wire_codec_blosc_24mb": lambda steps: bench_codec_agg(
        "wire_codec_blosc_24mb", min(steps, 3), codec="blosc"),
    "wire_codec_int8lat_24mb": lambda steps: bench_codec_agg(
        "wire_codec_int8lat_24mb", min(steps, 3), codec="int8lat"),
    "wire_codec_topk_24mb": lambda steps: bench_codec_agg(
        "wire_codec_topk_24mb", min(steps, 3), codec="topk", frac=0.01),
    "wire_codec_randk_24mb": lambda steps: bench_codec_agg(
        "wire_codec_randk_24mb", min(steps, 3), codec="randk", frac=0.01),
    # Serving: 8 requests batched (8 slots) and sequential (1 slot).
    "serve_sequential_8": lambda steps: bench_serving(
        "serve_sequential_8", steps, slots=1),
    "serve_batched_8": lambda steps: bench_serving(
        "serve_batched_8", steps, slots=8),
    "slo_sweep": lambda steps: bench_slo_sweep("slo_sweep", steps),
    "serve_reqtrace_overhead": lambda steps: bench_reqtrace_overhead(
        "serve_reqtrace_overhead", steps),
    # The ops, elastic and integrity planes' cost, <2% each.
    "ops_overhead": lambda steps: bench_ops_overhead(
        "ops_overhead", max(steps, 30)),
    "elastic_overhead": lambda steps: bench_elastic_overhead(
        "elastic_overhead", max(steps, 30)),
    "integrity_overhead": lambda steps: bench_integrity_overhead(
        "integrity_overhead", max(steps, 30)),
    # The quorum-replicated KV's cost on the wire bench, <5%.
    "kvrep_overhead": lambda steps: bench_kvrep_overhead(
        "kvrep_overhead", steps),
    # The flat star against the two-tier tree.
    "hier_sync_4slice": lambda steps: bench_hier_agg(
        "hier_sync_4slice", min(steps, 3), n_slices=4, group_size=2),
    "hier_sync_9slice": lambda steps: bench_hier_agg(
        "hier_sync_9slice", min(steps, 2), n_slices=9, group_size=3,
        payload_mb=4),
    # ZeRO over the wire; 1shard is the replicated baseline.
    "zero_wire_1shard": lambda steps: bench_zero(
        "zero_wire_1shard", steps, n_shards=1),
    "zero_wire_2shard": lambda steps: bench_zero(
        "zero_wire_2shard", steps, n_shards=2),
    "zero_wire_4shard": lambda steps: bench_zero(
        "zero_wire_4shard", steps, n_shards=4),
}


def _run_isolated(name: str, steps: int, timeout_s: float) -> dict:
    """One config in a child process with a hard wall-clock bound: a hung
    row is killed (freeing the card) and recorded, and the suite goes
    on. The child runs ``python -m ps_pytorch_tpu_torch.bench_suite`` from
    the repo root."""
    import subprocess
    import sys as _sys
    cmd = [_sys.executable, "-m", "ps_pytorch_tpu_torch.bench_suite",
           "--configs", name, "--steps", str(steps), "--device", DEVICE,
           "--ranks", str(DEVICES)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=timeout_s, cwd=REPO)
    except subprocess.TimeoutExpired:
        return {"config": name, "error": f"timeout after {timeout_s:.0f}s "
                                         "(killed; device freed)"}
    for r in reversed(_json_rows(res.stdout)):
        if r["config"] == name:
            return r
    return {"config": name,
            "error": f"child rc={res.returncode}: "
                     f"{(res.stderr or res.stdout)[-200:]}"}


def _json_rows(text: str) -> list:
    """The row lines (JSON objects with a ``config``) of ``text``."""
    rows = []
    for line in text.splitlines():
        if not line.startswith("{"):
            continue
        try:
            r = json.loads(line)
        except ValueError:
            continue
        if isinstance(r, dict) and "config" in r:
            rows.append(r)
    return rows


def _run_launch(names, steps: int, timeout_s: float) -> list:
    """``names`` (rows of :data:`SPANNING`) as one launch of ``DEVICES``
    rank processes (``tools/launch.py``, the suite as its entry) under a
    hard wall-clock bound; -> rank 0's rows, and an error row for each
    row it did not write (the launch's exit code and the logs' tails)."""
    from ps_pytorch_tpu_torch.tools.launch import run_fleet

    rc, logs = run_fleet("ps_pytorch_tpu_torch.bench_suite", DEVICES,
                         ["--configs", ",".join(names), "--steps",
                          str(steps), "--device", DEVICE], timeout_s)
    got = {r["config"]: r for r in _json_rows(logs[0])}
    tail = " | ".join(f"rank {r}: {log.strip()[-300:]}"
                      for r, log in enumerate(logs))
    return [got.get(name) or {"config": name, "error":
                              f"launch of {DEVICES} ranks rc={rc}: {tail}"}
            for name in names]


def _run_here(name: str, steps: int) -> dict:
    """One config in this process; its failure becomes the row."""
    try:
        return CONFIGS[name](steps)
    except Exception as e:  # one config failing must not lose the rest
        return {"config": name, "error": f"{type(e).__name__}: {e}"[:300]}


def _rank_main(names, steps: int, device: str) -> int:
    """The suite as one rank of a launch: join its group (the env
    contract), run each spanning row on every rank and the others on rank
    0 alone; rank 0 prints the rows. A spanning row that fails raises, so
    the launcher ends the fleet rather than leave the others waiting in a
    collective."""
    global DEVICES
    from ps_pytorch_tpu_torch.parallel import dist
    try:
        dist.initialize_from_env(device)
        DEVICES = dist.world()
        lead = dist.rank() == 0
        rows = []
        for name in names:
            if name in SPANNING:
                r = CONFIGS[name](steps)
            elif lead:
                r = _run_here(name, steps)
            else:
                continue
            if lead:
                print(json.dumps(r), flush=True)
                rows.append(r)
        if lead:
            derived_rows(rows)
        print(f"FINAL rank {dist.rank()} of {DEVICES}: {len(names)} "
              "configs", flush=True)
    finally:
        dist.shutdown()
    return 0


def _emit(rows, out) -> None:
    print(json.dumps(out), flush=True)
    rows.append(out)


def derived_rows(rows) -> None:
    """The JAX ``main``'s derived rows from the rows that ran: each printed
    and appended to ``rows``."""
    # Loader against the chip's demand: >= 2.0 feeds the chip with
    # headroom. The ImageNet pair prefers the augmented loader row.
    for chip_cfg, loader_cfgs, label in (
            ("resnet18_cifar10_dp", ("input_pipeline",),
             "loader_vs_chip_demand"),
            ("resnet50_imagenet", ("input_pipeline_imagenet_augmented",
                                   "input_pipeline_imagenet"),
             "loader_vs_chip_demand_imagenet")):
        chip = next((r for r in rows if r.get("config") == chip_cfg
                     and "images_per_sec" in r), None)
        loader = next((r for c in loader_cfgs for r in rows
                       if r.get("config") == c
                       and "loader_images_per_sec" in r), None)
        if chip and loader:
            ratio = loader["loader_images_per_sec"] / chip["images_per_sec"]
            print(json.dumps({"config": label,
                              "loader_config": loader["config"],
                              "ratio": round(ratio, 2),
                              "ok": ratio >= 2.0}), flush=True)

    # The wire: each blocking / overlapped pair's publish+read win, and
    # the two payloads bitwise equal; 1.25x is the bar.
    for row in list(rows):
        cfg_name = row.get("config", "")
        if not cfg_name.startswith("wire_blocking_") or "error" in row:
            continue
        size = cfg_name[len("wire_blocking_"):]
        over = next((r for r in rows
                     if r.get("config") == f"wire_overlapped_{size}"
                     and "error" not in r), None)
        if over is None:
            continue
        ratio = row["total_s"] / max(over["total_s"], 1e-9)
        bitwise = (row["payload_sha256"] == over["payload_sha256"])
        _emit(rows, {"config": f"wire_overlap_win_{size}",
                     "blocking_s": row["total_s"],
                     "overlapped_s": over["total_s"],
                     "ratio": round(ratio, 3), "bitwise_identical": bitwise,
                     "ok": bool(bitwise and ratio >= 1.25)})

    # The grad codecs against blosc's decode-then-average: topk needs a
    # >= 2x wire cut, int8lat an end-to-end win and bitwise identity.
    base = next((r for r in rows if r.get("config") == "wire_codec_blosc_24mb"
                 and "error" not in r), None)
    if base:
        for cname in ("int8lat", "topk", "randk"):
            row = next((r for r in rows
                        if r.get("config") == f"wire_codec_{cname}_24mb"
                        and "error" not in r), None)
            if row is None:
                continue
            wire_ratio = base["wire_mb"] / max(row["wire_mb"], 1e-9)
            total_ratio = base["total_s"] / max(row["total_s"], 1e-9)
            out = {"config": f"wire_codec_win_{cname}_24mb",
                   "baseline_wire_mb": base["wire_mb"],
                   "wire_mb": row["wire_mb"],
                   "wire_ratio": round(wire_ratio, 3),
                   "baseline_total_s": base["total_s"],
                   "total_s": row["total_s"],
                   "total_ratio": round(total_ratio, 3),
                   "bitwise_identical": row.get("bitwise_identical"),
                   "agg_rel_err": row.get("agg_rel_err")}
            if cname == "int8lat":
                out["ok"] = bool(out["bitwise_identical"]
                                 and total_ratio > 1.0 and wire_ratio >= 2.0)
            else:
                out["ok"] = bool(out["bitwise_identical"]
                                 and wire_ratio >= 2.0)
            _emit(rows, out)

    # The hierarchy must beat the flat star at >= 3 slices, its average
    # within the codec's tolerance.
    for row in list(rows):
        cfg_name = row.get("config", "")
        if not cfg_name.startswith("hier_sync_") or "error" in row:
            continue
        _emit(rows, {
            "config": f"hierarchy_win_{cfg_name[len('hier_sync_'):]}",
            "n_slices": row["n_slices"], "n_groups": row["n_groups"],
            "flat_s": row["flat_s"], "hier_s": row["hier_s"],
            "speedup": row["speedup"], "rel_err": row["rel_err"],
            "ok": bool(row["n_slices"] >= 3 and row["speedup"] > 1.0
                       and row["rel_err"] < 0.05)})

    # ZeRO over the wire: each N-shard row bitwise the 1shard baseline,
    # with ~1/N of its publish bytes and optimizer state a replica.
    zbase = next((r for r in rows if r.get("config") == "zero_wire_1shard"
                  and "error" not in r), None)
    if zbase:
        for row in list(rows):
            cfg_name = row.get("config", "")
            if not cfg_name.startswith("zero_wire_") or "error" in row \
                    or row is zbase or cfg_name.startswith("zero_wire_win"):
                continue
            n = row["shards"]
            wire_ratio = row["wire_out_mb_max"] / \
                max(zbase["wire_out_mb_max"], 1e-9)
            opt_ratio = row["opt_state_mb_max"] / \
                max(zbase["opt_state_mb_max"], 1e-9)
            bitwise = (row["params_sha256"] == zbase["params_sha256"])
            _emit(rows, {"config": f"zero_wire_win_{n}shard",
                         "shards": n,
                         "baseline_wire_out_mb": zbase["wire_out_mb_max"],
                         "wire_out_mb_max": row["wire_out_mb_max"],
                         "wire_out_ratio": round(wire_ratio, 3),
                         "baseline_opt_state_mb": zbase["opt_state_mb_max"],
                         "opt_state_mb_max": row["opt_state_mb_max"],
                         "opt_state_ratio": round(opt_ratio, 3),
                         "baseline_total_s": zbase["total_s"],
                         "total_s": row["total_s"],
                         "bitwise_identical": bitwise,
                         "ok": bool(bitwise and wire_ratio <= 0.75
                                    and opt_ratio <= 1.0 / n + 0.15)})

    # Serving: batched over sequential tokens a second (>= 1.5x) with
    # bitwise-identical tokens.
    seq = next((r for r in rows if r.get("config") == "serve_sequential_8"
                and "error" not in r), None)
    bat = next((r for r in rows if r.get("config") == "serve_batched_8"
                and "error" not in r), None)
    if seq and bat:
        ratio = bat["tokens_per_sec"] / max(seq["tokens_per_sec"], 1e-9)
        bitwise = (seq["tokens_sha256"] == bat["tokens_sha256"])
        _emit(rows, {"config": "serve_batch_win_8",
                     "sequential_tokens_per_sec": seq["tokens_per_sec"],
                     "batched_tokens_per_sec": bat["tokens_per_sec"],
                     "ratio": round(ratio, 3), "bitwise_identical": bitwise,
                     "ttft_p99_ms": bat["ttft_p99_ms"],
                     "latency_p99_ms": bat["latency_p99_ms"],
                     "ok": bool(bitwise and ratio >= 1.5)})


def markdown(rows) -> str:
    lines = ["| config | devices | global batch | sec/step | images/sec | vs baseline |",
             "|---|---|---|---|---|---|"]
    for r in rows:
        if "error" in r:
            lines.append(f"| {r['config']} | — | — | — | — | ERROR: {r['error'][:60]} |")
            continue
        if "images_per_sec" not in r:
            detail = (f"{r['seconds']} s total | — | converged={r['converged']}"
                      if "seconds" in r else
                      ", ".join(f"{k}={v}" for k, v in r.items()
                                if k != "config") + " | — | — ")
            lines.append(f"| {r['config']} | — | {r.get('steps','—')} steps "
                         f"| {detail} |")
            continue
        vs = f"{r['vs_baseline']}x" if r["vs_baseline"] else "n/a"
        lines.append(f"| {r['config']} | {r['devices']} | {r['global_batch']} "
                     f"| {r['sec_per_step']} | {r['images_per_sec']} | {vs} |")
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    global DEVICE, DEVICES
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--configs", default=",".join(CONFIGS))
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--markdown", default="", help="also write a table here")
    p.add_argument("--isolate", action="store_true",
                   help="run each config in its own process with "
                        "--row-timeout; a hung row is killed and recorded "
                        "instead of hanging the suite")
    p.add_argument("--row-timeout", type=float, default=600.0)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="the chip rows' device (cuda raises without a card)")
    p.add_argument("--ranks", type=int, default=0,
                   help="the world the spanning rows run over, one process "
                        "a rank (default: the cards the host shows; 1 "
                        "with --device cpu)")
    args = p.parse_args(argv)
    DEVICE = args.device
    names = [n.strip() for n in args.configs.split(",")]
    for name in names:
        if name not in CONFIGS:
            raise SystemExit(f"unknown config {name!r}; have {sorted(CONFIGS)}")
    from ps_pytorch_tpu_torch.parallel import dist
    if os.environ.get(dist.ENV_COORD):
        if args.ranks:
            raise SystemExit("--ranks in a launch: the launch's world is "
                             "the suite's")
        return _rank_main(names, args.steps, args.device)
    DEVICES = args.ranks or (max(torch.cuda.device_count(), 1)
                             if args.device == "cuda" else 1)

    rows = []
    pending: list = []

    def flush() -> None:
        if pending:
            for r in _run_launch(pending, args.steps,
                                 args.row_timeout * len(pending)):
                print(json.dumps(r), flush=True)
                rows.append(r)
            pending.clear()

    for name in names:
        if name in SPANNING and DEVICES > 1:
            pending.append(name)
            if args.isolate:        # a spanning row is a launch of its own
                flush()
            continue
        flush()
        if args.isolate:
            r = _run_isolated(name, args.steps, args.row_timeout)
        else:
            r = _run_here(name, args.steps)
        print(json.dumps(r), flush=True)
        rows.append(r)
    flush()
    derived_rows(rows)
    if args.markdown:
        with open(args.markdown, "w") as f:
            f.write(markdown(rows))
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
