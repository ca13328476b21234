"""Where a train step's time goes on the card: time and profile the port's
main path, then print one JSON digest line.

    python -m ps_pytorch_tpu_torch.tools.profile_capture --network ResNet18 \
        --dataset synthetic_cifar10 --batch-size 256 --eval-freq 0 \
        --conv-impl pallas --fused-optimizer --momentum 0.9 \
        --weight-decay 5e-4 [--warmup 5 --timed 30 --profiled 3 --out DIR]
    python -m ps_pytorch_tpu_torch.tools.profile_capture --network VGG11 \
        --dataset synthetic_cifar100 --batch-size 256 --eval-freq 0 \
        --conv-impl pallas --fused-optimizer --momentum 0.9
    python -m ps_pytorch_tpu_torch.tools.profile_capture \
        --network ResNet50_ImageNet --dataset synthetic_imagenet_rrc \
        --batch-size 128 --eval-freq 0 --conv-impl xla --fused-optimizer \
        --momentum 0.9 [--warmup 3 --timed 10 --profiled 2]
    python -m ps_pytorch_tpu_torch.tools.profile_capture --lm \
        --lm-attention flash --lm-d-model 512 --lm-layers 8 --lm-heads 8 \
        --lm-vocab 32000 --lm-seq-len 2048 --batch-size 8 --lr 0.01 \
        --momentum 0.9 --eval-freq 0 --resume false [--warmup 3 --timed 10]

It takes the trainer's flags (``--lm``: those of ``train_lm``), builds the
port's Trainer (``--lm``: LMTrainer) on ``cuda`` and drives its train step
on the loader's batches: ``--warmup`` steps (kernel builds, cuDNN
autotuning), ``--timed`` steps each ended by a
``torch.cuda.synchronize()`` on the host clock (median and spread of the
step time, images or tokens per second), then ``--profiled`` steps under
``torch.profiler``, whose device events give the time per kernel name,
grouped by what launched it, and the device's busy and idle share of the
profiled window (against the window itself, which the profiler's own host
cost stretches, and against the unprofiled median step), and the device
time charged to each PyTorch operator that launched it. The Chrome trace
is written to ``--out``; the digest carries the card's name and power
limit, and the step's ``mfu`` at the median (the model's FLOPs a step,
``utils/flops.py``, over the median and the card's bf16 peak). Without a
CUDA device it fails. The trainers pick deterministic
cuDNN algorithms (``runtime/trainer.py:set_reference_numerics``);
``--cudnn-nondeterministic`` lets cuDNN choose freely after the trainer is
built, to measure what determinism costs.
"""

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ps_pytorch_tpu_torch.config import add_train_args, config_from_namespace
from ps_pytorch_tpu_torch.data import augment
from ps_pytorch_tpu_torch.telemetry import compute_mfu

# Kernel-name fragments -> the group a device event is charged to.
GROUPS = (
    ("conv3x3 kernel (port)", ("conv3x3_tc_kernel", "conv3x3_tf32_kernel",
                               "conv3x3_simt_kernel")),
    ("fused_sgd kernel (port)", ("sgd_kernel",)),
    ("fused_adam kernel (port)", ("adam_kernel",)),
    ("flash kernels (port)", ("flash_fwd_tc_kernel", "flash_dq_tc_kernel",
                              "flash_dkv_tc_kernel")),
    ("cuDNN conv", ("cudnn", "conv2d", "implicit_convolve", "xmma_fprop",
                    "xmma_dgrad", "xmma_wgrad", "fprop", "dgrad", "wgrad")),
    ("matmul (cuBLAS)", ("gemm", "gemv", "cutlass", "xmma", "splitk")),
    ("softmax / cross-entropy", ("softmax", "nll_loss", "cross_entropy")),
    ("embedding", ("embedding", "index_select", "indexing_backward",
                   "index_add", "scatter", "gather")),
    ("pooling", ("max_pool", "avg_pool", "pool2d")),
    ("reduction", ("reduce", "norm", "batch_norm", "welford")),
    ("copy / layout", ("copy", "memcpy", "memset", "transpose", "cat",
                       "pad", "flip")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "fill")),
)


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals, in microseconds."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def trace_digest(path) -> dict:
    """Where a Chrome trace's time went (a trainer's ``--profile-dir``
    window, ``runtime/ops_plane.py``): the window from its first event to
    its last; the device's busy time (the union of its kernel, copy and
    set events) and its idle share of the window; device milliseconds by
    group (``GROUPS``, plus ``nccl`` for the collectives' kernels), the
    kernel count; and on the host, the operator count and the CUDA
    runtime calls by name (count and milliseconds): launches,
    synchronizations and copies."""
    events = [e for e in json.loads(Path(path).read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    if not events:
        raise ValueError(f"{path}: no timed events")
    device = [e for e in events if e.get("cat") in (
        "kernel", "gpu_memcpy", "gpu_memset")]
    start = min(e["ts"] for e in events)
    window = max(e["ts"] + e["dur"] for e in events) - start
    busy = busy_us((e["ts"], e["ts"] + e["dur"]) for e in device)
    groups, runtime = {}, {}
    for e in device:
        g = "nccl" if "nccl" in e["name"].lower() else group_of(e["name"])
        groups[g] = groups.get(g, 0.0) + e["dur"] / 1e3
    for e in events:
        if e.get("cat") == "cuda_runtime":
            n, ms = runtime.get(e["name"], (0, 0.0))
            runtime[e["name"]] = (n + 1, ms + e["dur"] / 1e3)
    return {"window_ms": window / 1e3, "device_busy_ms": busy / 1e3,
            "device_idle_share": max(0.0, 1.0 - busy / window),
            "kernels": sum(e.get("cat") == "kernel" for e in device),
            "host_ops": sum(e.get("cat") == "cpu_op" for e in events),
            "device_ms_by_group": dict(sorted(
                groups.items(), key=lambda kv: -kv[1])),
            "host_cuda_runtime": {k: {"calls": n, "ms": ms} for k, (n, ms)
                                  in sorted(runtime.items(),
                                            key=lambda kv: -kv[1][1])}}


def main(argv=None) -> int:
    parser = add_train_args()
    parser.add_argument("--warmup", type=int, default=5)
    parser.add_argument("--timed", type=int, default=30)
    parser.add_argument("--profiled", type=int, default=3)
    parser.add_argument("--out", default="train_dir_profile")
    parser.add_argument("--lm", action="store_true",
                        help="profile the LM train step (LMTrainer)")
    parser.add_argument("--cudnn-nondeterministic", action="store_true",
                        help="let cuDNN pick non-deterministic algorithms")
    args = parser.parse_args(argv)
    cfg = config_from_namespace(args)
    if args.lm:
        from ps_pytorch_tpu_torch.runtime.lm_trainer import LMTrainer
        trainer = LMTrainer(cfg, device="cuda")
        name = f"TransformerLM_{trainer.model.attention_impl}"
        per_step = {"tokens": cfg.batch_size * cfg.lm_seq_len}
        keys = ("batch_size", "lm_vocab", "lm_d_model", "lm_layers",
                "lm_heads", "lm_seq_len", "lm_attention")
    else:
        from ps_pytorch_tpu_torch.runtime import Trainer
        trainer = Trainer(cfg, device="cuda")
        name = f"{cfg.network}_{cfg.conv_impl}"
        per_step = {"images": cfg.batch_size}
        keys = ("network", "dataset", "batch_size", "compute_dtype",
                "conv_impl", "fused_optimizer")
    if args.cudnn_nondeterministic:
        torch.backends.cudnn.deterministic = False
    trainer.ops.count_flops()
    mask = np.ones(1, np.float32)
    batches = [trainer.train_loader.next_batch()
               for _ in range(args.warmup + args.timed + args.profiled)]

    def step(i):
        if args.lm:
            return trainer.step_fn(batches[i])
        x, y = batches[i]
        return trainer.step_fn(x, y, mask, key=cfg.seed * 100003 + i + 1)

    for i in range(args.warmup):
        step(i)
    torch.cuda.synchronize()
    times = []
    for i in range(args.warmup, args.warmup + args.timed):
        t0 = time.perf_counter()
        m = step(i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    loss = float(m["loss"])

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    first = args.warmup + args.timed
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        t0 = time.perf_counter()
        for i in range(first, first + args.profiled):
            step(i)
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    trace = out / f"trace_{name}.json"
    prof.export_chrome_trace(str(trace))

    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name, by_group = {}, {}
    for e in dev:
        us = e.time_range.end - e.time_range.start
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        g = group_of(e.name)
        by_group[g] = by_group.get(g, 0.0) + us
    busy = busy_us((e.time_range.start, e.time_range.end) for e in dev)
    n = args.profiled
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    ops = sorted(((a.key, getattr(a, "self_device_time_total", 0.0))
                  for a in prof.key_averages()), key=lambda kv: -kv[1])[:15]
    q = statistics.quantiles(times, n=4) if len(times) >= 2 else times * 3
    digest = {
        "card": card_line(),
        "config": {k: getattr(cfg, k) for k in keys},
        "cudnn_deterministic": torch.backends.cudnn.deterministic,
        "loss_after_timed_steps": loss,
        "step_s": {"median": statistics.median(times), "q1": q[0],
                   "q3": q[2], "min": min(times), "max": max(times),
                   "n": len(times)},
        **{f"{unit}_per_s_at_median": count / statistics.median(times)
           for unit, count in per_step.items()},
        "flops_per_step": trainer.ops.flops_per_step,
        "mfu_at_median": compute_mfu(
            trainer.ops.flops_per_step, statistics.median(times),
            trainer.ops.peak_per_chip),
        "profiled_steps": n,
        "device_busy_ms_per_step": busy / 1e3 / n,
        "window_ms_per_step": window_us / 1e3 / n,
        # The profiler slows the host, so the profiled window overstates
        # idle time; the share against the unprofiled median is the other
        # bound.
        "device_idle_share_of_window": max(0.0, 1.0 - busy / window_us),
        "device_idle_share_of_median_step": max(
            0.0, 1.0 - busy / 1e6 / n / statistics.median(times)),
        "device_ms_per_step_by_group": {
            g: round(us / 1e3 / n, 4) for g, us in sorted(
                by_group.items(), key=lambda kv: -kv[1])},
        "device_ms_per_step_top_kernels": [
            [name[:90], round(us / 1e3 / n, 4)] for name, us in top],
        "device_ms_per_step_top_ops": [
            [name, round(us / 1e3 / n, 4)] for name, us in ops if us > 0],
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        **({"rrc_backend": augment.rrc_backend()}
           if cfg.dataset in augment.RRC_STACKS else {}),
        "trace": str(trace),
    }
    print(json.dumps(digest), flush=True)
    if not dev:
        print("no device events in the profile: torch.profiler saw no "
              "CUDA activity", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
