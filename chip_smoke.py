#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA card: ``python3 chip_smoke.py``.

It drives only ``ps_pytorch_tpu_torch`` (no JAX) and fails, with a non-zero
exit and no result line, if any phase fails:

1. prints the card's name and power limit (nvidia-smi);
2. builds every CUDA kernel from ``ps_pytorch_tpu_torch/csrc`` (one nvcc per
   source, in parallel, beside the g++ build of the RRC loader's native
   kernel, ``native/loader.cpp``, into ``ps_pytorch_tpu_torch/build``; it
   fails unless that kernel is the one the loader runs) and compiles the
   Triton kernels;
3. holds each kernel against its plain PyTorch version on the card at the
   shapes of the main paths, and times kernel, plain version, the library
   call that computes the same function (``F.conv2d``,
   ``torch.optim.SGD(fused=True)``, ``torch.optim.Adam(fused=True)``,
   ``F.scaled_dot_product_attention`` forward and backward; the port never
   calls them; no single PyTorch call computes the int8 stochastic-rounding
   quantizer, so it has none) and the bound (bytes over 3.35 TB/s or operations over the
   peak rate of their type, whichever is larger); conv3x3 runs f32 through
   its SIMT kernel and bf16 and f16 through its tensor-core kernel (an f16
   view off a 16-byte boundary through the SIMT one), and the 16-bit
   rows also time the SIMT kernel on the same inputs; the three flash
   kernels run on the tensor cores (f32 as 3xTF32; bf16 and f16 as the
   JAX op's 16-bit forms) and print a second
   bound at that route's rate, ``bound_tc_ms``; the tree quantizer runs a
   whole gradient tree in one launch, with its noise drawn in the kernel
   (Philox) and with the caller's; then times the conv's weight gradient
   (torch ops) over one step's calls;
4. trains full-width ResNet-18 (synthetic CIFAR-10, batch 256, bf16, conv
   ``pallas``, fused SGD) for a few steps through the port's Trainer, then
   evaluates 2 batches; then the same network in float16 through the
   entry points (MAIN-F16: ``train.main`` with checkpoints at 2 and 4 of 4
   steps, ``evaluate.main --once 4``, a resume from step 2 equal to the
   uninterrupted run bit for bit, and the step-1 loss of one
   ``--conv-impl xla`` step, cuDNN in f16, within rtol 1e-2); then the same
   network trained asynchronously by 2
   slices through ``train.main --mode async`` with every gradient tree
   through one launch of the int8 quantize kernel on submit, a mixed-rate
   schedule with
   stale gradients, and a compressed checkpoint that is resumed and scored
   by ``evaluate.main``, and LeNet in slices of two devices a slice
   (``MultiSliceTrainer(devices=["cuda:0"] * 4, n_slices=2)``) held against
   the same trainer on the CPU; then the same network with fused Adam through the
   entry points a user calls: ``train.main`` checkpointing every 3 of 6
   steps, a resumed Trainer to step 8 held against an uninterrupted one,
   and ``evaluate.main --once 6``; then the same ResNet-18 as processes
   through the port's launcher, each rank this script's rank mode
   (``--rank``: ``train.run`` between zeroed and read counts): after a
   probe that gloo all-reduces a CUDA tensor between two ranks on the
   card, one rank over NCCL (MAIN-DIST) and two ranks on the one card over
   gloo (MAIN-KOFN: K-of-N with process 0 slowed by 0.3 s a step, its
   masks, process 0's checkpoints scored by ``evaluate.main``, equal
   parameter hashes, and a sync run with the same straggler for its
   cost), then two gloo ranks on the card each training twice in one
   process group (MAIN-ZERO, ``--rank <run> --then <run>``: ZeRO-1 with
   ``--sync-batchnorm --remat --loader-workers 4`` and heartbeats, then the
   same replicated; equal parameter hashes across the runs and the ranks,
   half the optimizer state a rank, process 0's ZeRO checkpoint in the JAX
   layout scored by ``evaluate.main``), then two processes on the card as
   asynchronous slices over the KV wire (MAIN-WIRE, ``--rank-wire``: ``train.run --mode async``, int8
   to version 4 with checkpoints every 2, resumed to 6 and scored by
   ``evaluate.main``, blosc on the bucketed wire, raw on the blocking one;
   equal FINAL lines, process 0's checkpoints, a quantize launch a tick a
   process and a fused SGD launch an applied version, the armoured bytes
   a submission against the sizes, and, before it, one int8 ResNet-18
   gradient tree's chunks from the kernel and from the plain version
   hashed equal), then leadership: three processes on the card as
   asynchronous slices with the PS leader a lease (MAIN-ELECT,
   ``--rank-elect``: ``--elastic --elastic-leader 1``, the int8 wire,
   process 1 SIGKILLed by ``leader_kill`` at its fourth tick; one survivor
   elected at epoch 2 finishes the run through the fused SGD kernel, both
   survivors hash the same final parameters, ``evaluate.main`` scores the
   new leader's last checkpoint), and two gloo ranks whose control plane
   rides a quorum of three backends, two directories and an HTTP server
   of ``python -m ps_pytorch_tpu_torch.runtime.kvrep`` (MAIN-KVREP: one
   backend dead for two steps, another wiped, the parameters bitwise those
   of the static run that follows in the same launch, ejections and
   resyncs counted, no retry given up); between those two, the sharded
   wire update held bitwise across 1, 2 and 3 shards on ResNet-18's tree
   from the card (CHECK zero-wire), three processes on ``--shard-wire``
   whose leader is SIGKILLed, the promoted leader restoring the sharded
   optimizer state from the dead leader's checkpoint (MAIN-SHARD,
   ``--rank-shard``: one election, one final hash, the ``"zero"`` state in
   the last checkpoint over all 3 shards, the channel carrying the
   BatchNorm statistics only, no fused SGD, ``evaluate.main`` scoring it;
   then two slices in one process resumed bitwise), the integrity screen
   on the card held against its CPU copies (CHECK integrity), and four
   processes with process 2 poisoning its int8lat gradients by 1e38
   (MAIN-POISON, ``--rank-poison``: the leader quarantines and readmits
   contributor 2, counts a caught bit-flip, its exporter shows the
   quarantine, all four losses finite), then the hierarchical topology:
   ResNet-18's gradient tree from the card through the two-tier
   aggregator against its CPU copies and the flat average, and the
   hierarchy drill's bitwise phase at that width (CHECK hier), four
   processes in two groups of two on ``--sync-topology hier`` with group
   1 cut off the KV mid-run (MAIN-HIER, ``--rank-hier``: the root
   declares the subtree partitioned, applies group 0's updates, re-grafts
   group 1 after the heal, all four FINAL lines equal, ``evaluate.main``
   scoring the leader's checkpoint) and four slices in one process on
   it, resumed bitwise from a checkpoint with both tiers' error
   feedback; before those, VGG11 (MAIN-VGG: BatchNorm, biased convs,
   Dropout, synthetic CIFAR-100, batch 256) and ResNet-50 at 224 px on the
   random-resized-crop loader (MAIN-IMAGENET: batch 128, uint8 batches)
   through ``train.main`` and ``evaluate.main --once``, each after the
   bf16 and f16 conv3x3 checks at its geometries (VGG11's channel ladder from
   16x16 down to 2x2, ResNet-50's 56, 28, 14 and 7 px stages); then the
   full-width TransformerLM (d 512, 8 layers, 8 heads, vocab 32000, S
   2048, batch 8, f32, flash
   attention) for a few steps through the port's LMTrainer, evaluating 2
   batches, then the same model at S 8192 and batch 1, the JAX
   ``transformer_lm_8k_flash`` row (MAIN-LM8K: the flash kernels at [1, 8,
   8192, 64] against their plain versions and SDPA, ``train_lm.run`` for 3
   steps, ``evaluate.main`` through the flash oracle and the same
   checkpoint through the full-attention oracle, the two EVAL_LM lines and
   FINAL's batches within 1e-4), then its checkpoint lifecycle through the entry points
   (MAIN-LMCKPT: ``train_lm.main --remat --eval-freq 2`` with the step-4
   checkpoint corrupted, a resume that walks back to step 2 and trains to
   6, ``evaluate.main --once 6``'s EVAL_LM line, greedy
   ``generate.main`` against the full forward's argmax on the card, the
   checkpoint's bytes and save and load seconds), then the memory probe
   (MEMORY: ``tools/memory_probe.py`` at the JAX geometry, the modes
   lm_base, lm_remat, lm_flash, cnn_base and cnn_remat each in a child
   process of its own, all at once: no row with an error, lm_remat and
   lm_flash each peaking below lm_base, lm_flash's flash launches 3 steps
   x 8 layers of each kernel, all on the tensor cores; the CNN rows'
   peaks and step times with and without remat) and the JAX package's
   ACCURACY_LM recipe, taken from ``tools/accuracy_run.py``, on the flash
   kernels (ACCURACY-LM: 2000 steps on the ``.py`` bytes of
   ``ps_pytorch_tpu/`` and ``tests/``, read as files, then
   ``evaluate.main``; perplexity at most 16); between those two, MAIN-LMCKPT's
   checkpoints served (MAIN-SERVE: ``ServingEngine`` at 1, 4 and 8 slots,
   every stream equal to ``generate`` token for token and no kernel
   launched, its tokens/s, TTFT, latency and ms a tick; ``python -m
   ps_pytorch_tpu_torch.serve`` over HTTP with a reload past a corrupt
   checkpoint under load and a SIGTERM drain; two replicas behind the
   router, one SIGKILLed by ``replica_kill``, every request answered),
   and before MAIN-SERVE the same model across two gloo ranks sharing the
   card, one launch of five runs (MAIN-LMDIST, ``--rank-lmdist``:
   ``train_lm.run`` with ``--lm-parallelism sp`` over both ranks on ring
   attention, ``tp`` over the model axis, and ``pp`` of 2 stages x 4
   microbatches on the flash kernels under remat, 3 steps and a
   checkpoint at 3 each; every run's FINAL line equal on both ranks, rank
   0 alone writing, the bytes each rank hands gloo a step equal to the
   shapes' count, pp's flash launches those of its schedule,
   ``evaluate.main`` scoring pp's stage-stacked checkpoint, each run's
   step-1 loss and step-2 parameters held against the one-rank LM; and
   as a fourth run the MoE LM of the JAX ``moe_lm_2k`` row, 8 experts a
   block, with ``--lm-parallelism ep``, its experts sharded over the two
   ranks and its tokens crossing by all-to-all (MAIN-MOE: the bytes a
   step, the flash launches, step 1 and step 2 against the one-rank MoE
   in two capacity groups, ``evaluate.main`` against the one-group
   full-attention oracle, greedy ``generate.main`` against the full
   forward's argmax in one capacity group a token); as a fifth, tp with 7
   heads at d 448, which the model axis does not divide, held like tp;
   then sp's checkpoint scored by ``evaluate.main`` on both ranks (the
   ring over them) and in this process (the flash oracle), within 1e-4 of
   sp's FINAL; its ranks also probe
   that gloo all-reduces a CUDA tensor between two ranks on the card
   (PROBE-GLOO, a launch of its own until MAIN-MOE needed the time).
   After MAIN-CKPT, the same ResNet-18 through ``train.main``
   with a crash, a corrupted checkpoint and KV drops under
   ``--auto-resume 2`` (MAIN-CRASH: the resume past the corrupt checkpoint
   ends bitwise where an uninterrupted run ends, retries equal drops, and
   SIGTERM to a run of its own commits an emergency checkpoint). Right
   after MAIN, the same ResNet-18 through ``train.run``
   with every flag of the ops plane (MAIN-TELEMETRY: 8 steps, the JSONL,
   the Chrome trace of its spans, a ``torch.profiler`` window over steps
   3-4 whose kernels include conv3x3's tensor-core kernel, the exporter
   scraped by a thread while the steps run, the health spec), then two
   Trainers whose coordinator hands out a NaN mask at step 3 (HEALTH:
   ``nonfinite:halt`` stops there with ``model_step_3`` and a flight dump,
   ``nonfinite:skip`` keeps the parameters bitwise and trains on). MAIN,
   MAIN-TELEMETRY, MAIN-VGG, MAIN-IMAGENET and MAIN-LM print their FLOPs a
   step (the JAX package's xla / full-attention count, ``FLOPS_A_STEP``)
   and a numeric ``mfu`` on every STEP line, each JSONL row's within 1e-6
   of that count over its step time and the H100's 989 TFLOP/s. Every
   launch count is set to 0 just before each path and read just after: each kernel of the path ran the expected number of times,
   no other kernel ran, and every bf16 conv3x3 launch and every flash
   launch took the tensor-core kernel (``conv3x3_tc``, ``flash_fwd_tc``,
   ``flash_dq_tc``, ``flash_dkv_tc``);
   Before MAIN-CKPT, the fused SGD and Adam kernels on each replica's
   slice of a padded flat buffer, as the sharded update runs them (CHECK
   zero slice);
5. holds one small ResNet step in f32 (SIMT conv only) and one each in
   bf16 and f16 (tensor-core conv only), one small bf16 VGG step (the same
   injected
   Dropout masks) and one of a ResNet with the ImageNet stem, two small
   asynchronous ticks (the same
   injected rounding noise) and one small LM step on the card against the
   same steps on the CPU (the plain versions);
6. trains LeNet on the UCI digits for 1200 steps through the port's
   ``tools/accuracy_run.py`` (``python -m ps_pytorch_tpu_torch.train``,
   then ``evaluate --once`` on the checkpoint, each a process, beside
   ACCURACY-LM): Prec@1 must reach 0.98;
7. prints the ``kernels`` JSON line, the card line, and last
   ``{"ok": true, "device": {...}}``.
"""

import atexit
import io
import json
import math
import os
import re
import shutil
import socket
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager, redirect_stdout
from pathlib import Path

import numpy as np

STEPS = 5
EVAL_BATCHES = 2
BATCH = 256
# ResNet-18's stride-1 3x3 convs at CIFAR geometry: (H=W, C=Co, count).
GEOMETRIES = ((32, 64, 4), (16, 128, 3), (8, 256, 3), (4, 512, 3))
CONV_PER_STEP = 2 * sum(n for _, _, n in GEOMETRIES)     # fwd + input grad
CONV_PER_EVAL_BATCH = sum(n for _, _, n in GEOMETRIES)
HBM_BYTES_PER_S = 3.35e12          # H100 SXM
# Tensor-core bf16 and f16 (dense); f32 FMA on the CUDA cores.
PEAK_OPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
ELEMENT_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}
# conv3x3 against its plain version on the card: f32 sums in another order
# (1e-4); bf16 rounded once from f32 sums (2e-2, about one ulp at 2-4); f16
# likewise (5e-3, about 2.5 ulp of f16 at 2).
CONV_TOL = {"float32": 1e-4, "bfloat16": 2e-2, "float16": 5e-3}
TF32_OPS = 495e12                  # tensor-core TF32; 3xTF32 takes 3 of them
# The LM of the JAX package's transformer_lm_2k_flash benchmark: its one
# attention call per layer is [batch 8, 8 heads, S 2048, head dim 64].
LM_ARGS = ("--lm-attention", "flash", "--lm-d-model", "512", "--lm-layers",
           "8", "--lm-heads", "8", "--lm-vocab", "32000", "--lm-seq-len",
           "2048", "--batch-size", "8", "--lr", "0.01", "--momentum", "0.9")
LM_LAYERS, LM_BATCH, LM_SEQ = 8, 8, 2048
FLASH_SHAPE = (8, 8, 2048, 64)
# Kernel against plain version: forward 2e-5 and gradients 5e-4 in f32,
# 2e-2 in bf16 (outputs rounded once from f32): the JAX package's own; f16
# 1e-2 (p and ds rounded to f16 on the tiles, as bf16 rounds them to bf16).
FLASH_TOL = {"float32": (2e-5, 5e-4), "bfloat16": (2e-2, 2e-2),
             "float16": (1e-2, 1e-2)}
FLASH_MATMULS = {"flash_fwd": 2, "flash_dq": 3, "flash_dkv": 4}
# Beside the LM's shape: the widest head dim, causal, in all types; a head
# dim whose 16-bit depth is padded from 40 to 48; a full (non-causal)
# shape; an S that is not a multiple of the kernels' 64-row tile;
# ACCURACY-LM's [batch 16, 4 heads, S 256, head dim 32]. f16 is the JAX
# op's f16 form (no trainer path computes attention in f16): the LM's
# shape, D 128, the padded D 40, and full.
FLASH_CASES = ((FLASH_SHAPE, True, "float32"), (FLASH_SHAPE, True, "bfloat16"),
               (FLASH_SHAPE, True, "float16"),
               ((2, 4, 512, 128), True, "float32"),
               ((2, 4, 512, 128), True, "bfloat16"),
               ((2, 4, 512, 128), True, "float16"),
               ((2, 4, 1000, 40), True, "bfloat16"),
               ((2, 4, 1000, 40), True, "float16"),
               ((2, 4, 512, 64), False, "float32"),
               ((2, 4, 512, 64), False, "float16"),
               ((2, 4, 1000, 64), True, "float32"),
               ((16, 4, 256, 32), True, "float32"))
# ResNet-18 with fused Adam through the entry points: checkpoints every 3
# of 6 steps, then a resume to step 8.
CKPT_ARGS = ("--network", "ResNet18", "--dataset", "synthetic_cifar10",
             "--batch-size", str(BATCH), "--compute-dtype", "bfloat16",
             "--conv-impl", "pallas", "--optimizer", "adam",
             "--fused-optimizer", "--lr", "1e-3", "--weight-decay", "5e-4")
# ResNet-18 trained by two asynchronous slices, int8 gradients between them.
# The test set's 8333 images make 2 eval batches of 4167.
ASYNC_TICKS = 4
ASYNC_ARGS = ("--mode", "async", "--async-slices", "2", "--network",
              "ResNet18", "--dataset", "synthetic_cifar10", "--batch-size",
              str(BATCH), "--compute-dtype", "bfloat16", "--conv-impl",
              "pallas", "--fused-optimizer", "--momentum", "0.9",
              "--weight-decay", "5e-4", "--compress-grad", "--grad-codec",
              "int8", "--test-batch-size", "4167")
QUANT_SIZES = (1, 4096, 4097, 100_003, 2_359_296, 11_173_962)
# The CNN path's ResNet-18 run as processes through the port's launcher,
# each rank this script's rank mode: one rank (MAIN-DIST, NCCL), then two
# ranks on the one card (MAIN-KOFN, gloo) K-of-N with one backup worker and
# process 0 made a straggler; 8333 test images make 2 eval batches of 4167.
DIST_ARGS = ("--network", "ResNet18", "--dataset", "synthetic_cifar10",
             "--batch-size", str(BATCH), "--compute-dtype", "bfloat16",
             "--conv-impl", "pallas", "--fused-optimizer", "--momentum",
             "0.9", "--weight-decay", "5e-4", "--test-batch-size", "4167",
             "--resume", "false", "--device", "cuda")
KOFN_STEPS = 8
KOFN_ARGS = ("--mode", "kofn", "--num-aggregate", "1", "--inject-step-delay",
             "0.3", "--inject-delay-process", "0", "--max-steps",
             str(KOFN_STEPS), "--eval-freq", "4")
RANK_TIMEOUT_S = 400
# The directory where the script's processes share the synthetic data sets
# (``arrays_made_once``), and the sets the phases draw (data set, train
# split, seed), made while the kernels build.
ARRAYS_ENV = "CHIP_SMOKE_ARRAYS"
PHASE_ARRAYS = tuple((name, train, seed) for name, seed in (
    ("synthetic_cifar10", 42), ("synthetic_cifar10", 43),
    ("synthetic_cifar10", 44), ("synthetic_mnist", 42),
    ("synthetic_cifar100", 42), ("synthetic_imagenet_rrc", 42))
    for train in (True, False)) + (("synthetic_cifar10", False, 0),)
# MAIN-WIRE: the same ResNet-18 as two processes on the one card, async
# across processes (runtime/async_trainer.py): gradients and the canonical
# weights cross between them as armoured chunks over process 0's TCPStore.
# (name, codec flags, max steps, eval freq, resume): int8 with checkpoints
# every 2 versions, resumed from 4 to 6; blosc on the default bucketed
# wire; raw on the blocking legacy wire.
WIRE_ARGS = ("--mode", "async", "--staleness-limit", "8", "--network",
             "ResNet18", "--dataset", "synthetic_cifar10", "--batch-size",
             str(BATCH), "--compute-dtype", "bfloat16", "--conv-impl",
             "pallas", "--fused-optimizer", "--momentum", "0.9",
             "--weight-decay", "5e-4", "--test-batch-size", "4167",
             "--device", "cuda")
WIRE_INT8 = ("--compress-grad", "true", "--grad-codec", "int8")
# The int8 run's versions before its resume (cut from 6 to 4, and blosc's
# from 3 to 2, to make room for MAIN-HIER in the script's time; blosc's and
# raw's to 1 each for MAIN-F16's).
WIRE_INT8_STEPS = 4
# The launches, each a tuple of runs in one process group: the resumed
# int8 run, blosc and raw in one launch, blosc and raw under seeds of
# their own, so that their wire keys (``async-<seed>/...``) are not those
# of the run before them in the group.
WIRE_LAUNCHES = ((("int8", WIRE_INT8, WIRE_INT8_STEPS, 2, False),),
                 (("int8-resumed", WIRE_INT8, WIRE_INT8_STEPS + 2, 2, True),
                  ("blosc", ("--compress-grad", "true", "--grad-codec",
                             "blosc", "--seed", "44"), 1, 0, False),
                  ("raw", ("--compress-grad", "false", "--wire-bucket-mb",
                           "0", "--seed", "43"), 1, 0, False)))
WIRE_SAVES = {"int8": [2, 4], "int8-resumed": [6], "blosc": [], "raw": []}
# VGG11 (with BatchNorm) on synthetic CIFAR-100, the JAX package's
# vgg11_cifar100_kofn / vgg11_pallas_conv (bench_suite.py:1450, 1511):
# batch 256, SGD lr 0.05 momentum 0.9; 8333 test images make 2 eval
# batches of 4167.
VGG_STEPS = 5
VGG_ARGS = ("--network", "VGG11", "--dataset", "synthetic_cifar100",
            "--batch-size", str(BATCH), "--test-batch-size", "4167",
            "--compute-dtype", "bfloat16", "--conv-impl", "pallas",
            "--fused-optimizer", "--lr", "0.05", "--momentum", "0.9",
            "--resume", "false", "--device", "cuda")
# VGG11's 7 convs past its 3-channel input conv at 32 px: (H=W, C, Co,
# count); the input gradients run Co -> C.
VGG_GEOMETRIES = ((16, 64, 128, 1), (8, 128, 256, 1), (8, 256, 256, 1),
                  (4, 256, 512, 1), (4, 512, 512, 1), (2, 512, 512, 2))
# ResNet-50 at 224 px on the RRC loader (bench_suite.py:1454,
# resnet50_imagenet: SGD lr 0.05 momentum 0.9, :1400), uint8 batches
# normalized in the step; the 512 test
# images (center crop) make one eval batch.
IMAGENET_BATCH = 128
IMAGENET_STEPS = 4
IMAGENET_ARGS = ("--network", "ResNet50_ImageNet", "--dataset",
                 "synthetic_imagenet_rrc", "--batch-size",
                 str(IMAGENET_BATCH), "--compute-dtype", "bfloat16",
                 "--conv-impl", "pallas", "--fused-optimizer", "--lr", "0.05",
                 "--momentum", "0.9",
                 "--device-normalize", "true", "--resume", "false",
                 "--device", "cuda")
# ResNet-50's 13 stride-1 3x3s at 224 px: (H=W, C, Co, count).
RESNET50_GEOMETRIES = ((56, 64, 64, 3), (28, 128, 128, 3), (14, 256, 256, 5),
                       (7, 512, 512, 2))
# MAIN-F16: MAIN's ResNet-18 in float16 (the JAX package's --compute-dtype
# float16, models/__init__.py:20) through the entry points: 4 steps with
# checkpoints at 2 and 4, evaluate.main on step 4, a resume from step 2 to
# 4, and one step of the same run with --conv-impl xla (cuDNN in f16) for
# the step-1 loss. 8333 test images make 2 eval batches of 4167.
F16_STEPS = 4
F16_EVAL_BATCHES = 2
F16_ARGS = ("--network", "ResNet18", "--dataset", "synthetic_cifar10",
            "--batch-size", str(BATCH), "--test-batch-size", "4167",
            "--compute-dtype", "float16", "--fused-optimizer", "--momentum",
            "0.9", "--weight-decay", "5e-4", "--device", "cuda")
# MAIN-ZERO: the CNN path's ResNet-18 as two gloo ranks on the card, ZeRO-1
# then replicated, with every step option of the slice. The heartbeat
# deadline is long enough for the first step's kernel builds.
ZERO_STEPS = 6
ZERO_ARGS = (*DIST_ARGS, "--sync-batchnorm", "--remat", "--loader-workers",
             "4", "--heartbeat-interval-s", "0.5", "--heartbeat-timeout-s",
             "30", "--max-steps", str(ZERO_STEPS), "--eval-freq",
             str(ZERO_STEPS))
# MAIN-CRASH: the same network through train.main in this process.
CRASH_ARGS = ("--network", "ResNet18", "--dataset", "synthetic_cifar10",
              "--batch-size", str(BATCH), "--test-batch-size", "4167",
              "--compute-dtype", "bfloat16", "--conv-impl", "pallas",
              "--fused-optimizer", "--momentum", "0.9", "--weight-decay",
              "5e-4", "--eval-freq", "2", "--ckpt-keep", "3", "--device",
              "cuda")
CRASH_SPEC = "replica_crash:r=0,step=5;ckpt_corrupt:step=6;kv_drop:p=0.05,seed=7"
# MEMORY: the memory probe's modes at the JAX geometry, all five children
# at once (their peaks, 21.0, 7.2, 12.6, 6.6 and 6.6 GB on the card, fit
# it together; each peak is its own process's); lm_flash's launches are
# its 3 steps' of the 8 layers.
MEMORY_MODES = ("lm_base", "lm_remat", "lm_flash", "cnn_base", "cnn_remat")
MEMORY_JOBS = len(MEMORY_MODES)
MEMORY_STEPS = 3
# MAIN-ELECT: the same ResNet-18 as three processes on the card, async over
# the KV wire with the int8 codec, the PS leader a lease (--elastic) held
# first by process 1 (process 0 serves the TCPStore, as in the JAX
# drill, tools/elastic_drill.py:61-80). Process 1 alone is armed with
# leader_kill: the fault fires on whoever leads at a tick >= K, so armed
# everywhere it would kill the winner too. A checkpoint every 2 versions
# exists before the kill; the lease (3 s, stale after 9 s) outlasts a
# leader tick.
ELECT_STEPS = 8
ELECT_KILL = 4
ELECT_ARGS = ("--mode", "async", "--staleness-limit", "8", "--network",
              "ResNet18", "--dataset", "synthetic_cifar10", "--batch-size",
              "128", "--compute-dtype", "bfloat16", "--conv-impl", "pallas",
              "--fused-optimizer", "--momentum", "0.9", "--weight-decay",
              "5e-4", "--test-batch-size", "4167", "--compress-grad", "true",
              "--grad-codec", "int8", "--elastic", "--elastic-leader", "1",
              "--leader-lease-s", "3", "--eval-freq", "2", "--max-steps",
              str(ELECT_STEPS), "--resume", "false", "--device", "cuda")
# MAIN-KVREP: the CNN path's ResNet-18 as two gloo ranks, K-of-N with both
# counted, the control plane on three backends (two directories and an
# HTTP server of runtime/kvrep.py in a process of its own): backend 2 dead
# for steps 3-4, backend 1 wiped at step 5; then the same run on the
# static control plane. A short probation (--kv-resync-s) lets the dead
# backend rejoin within the run.
KVREP_STEPS = 8
KVREP_ARGS = (*DIST_ARGS, "--mode", "kofn", "--num-aggregate", "2",
              "--max-steps", str(KVREP_STEPS), "--eval-freq",
              str(KVREP_STEPS))
KVREP_FAULTS = ("kv_backend_kill:backend=2,step=3,steps=2;"
                "kv_backend_wipe:backend=1,step=5")
# MAIN-SHARD: the same ResNet-18 as three processes on the card, async on
# the sharded wire update (--shard-wire, the leader owning max(3, 2) = 3
# shards, the update on the host), the blosc codec, the PS leader a lease
# held first by process 1 and SIGKILLed at its tick SHARD_KILL (the JAX
# drill, tools/elastic_drill.py:61-80); a checkpoint every 2 versions
# carries the sharded optimizer state to the promoted leader.
SHARD_STEPS = 8
SHARD_KILL = 4
SHARD_ARGS = ("--mode", "async", "--shard-wire", "--compress-grad", "true",
              "--grad-codec", "blosc", "--staleness-limit", "8",
              "--network", "ResNet18", "--dataset", "synthetic_cifar10",
              "--batch-size", "128", "--compute-dtype", "bfloat16",
              "--conv-impl", "pallas", "--fused-optimizer", "--momentum",
              "0.9", "--weight-decay", "5e-4", "--test-batch-size", "4167",
              "--elastic", "--elastic-leader", "1", "--leader-lease-s", "3",
              "--eval-freq", "2", "--max-steps", str(SHARD_STEPS),
              "--resume", "false", "--device", "cuda")
# The raw f32 parameter payload of ResNet-18 on the replicated wire, the
# transport's canonical publish as MAIN-WIRE measures it (PERF.md): what
# --shard-wire moves off the transport's parameter channel.
RAW_PARAM_PUBLISH_BYTES = 55.9e6
# MAIN-SHARD's in-process leg: two slices on --shard-wire, 4 ticks
# uninterrupted against 2 ticks, a checkpoint, and a resume to 4.
SHARD_SLICE_ARGS = ("--mode", "async", "--async-slices", "2", "--shard-wire",
                    "--network", "ResNet18", "--dataset",
                    "synthetic_cifar10", "--batch-size", str(BATCH),
                    "--compute-dtype", "bfloat16", "--conv-impl", "pallas",
                    "--fused-optimizer", "--momentum", "0.9",
                    "--weight-decay", "5e-4")
# MAIN-POISON: the JAX poison drill's poison leg (tools/poison_drill.py:
# 262-293) on ResNet-18: four processes of batch 64 (global 256), int8lat
# without error feedback, the integrity screen on (the default); process 2
# scales its own gradients by 1e38 for POISON_WINDOW of its steps, and the
# leader's gradient chunk reads are bit-flipped at p = 0.002. The leader
# reads only each follower's newest contribution, and a ResNet-18
# contribution is ~50 chunks: at the drill's p = 0.01 the digest demoted
# about half of those reads, so strikes came at the host's pace (2 to 9
# over a window of 80 poisoner steps, 48 versions; one run quarantined
# nothing). At p = 0.002 a read fails ~10% of the time (1 - 0.998^50), a
# screen comes about once a version, and the quarantine (3 strikes) and
# readmission (3 clean screens) each take ~3-4 versions. The window of 40
# steps spans ~9-13 versions (a follower takes 3-4.6 steps a leader tick),
# so the readmission comes by version ~20, and the bit-flips still fail
# ~8 reads a run. On the card it came at version 15 in the three runs that
# measured it, so 20 versions (28 until MAIN-MOE needed the time, 24 until
# MAIN-F16 did) leave five to spare.
POISON_STEPS = 20
POISON_WINDOW = 40
POISON_SPEC = (f"grad_poison:scale=1e38,r=2,step=3,steps={POISON_WINDOW};"
               "payload_bitflip:p=0.002,seed=11,prefix=async-42/agrad")
POISON_ARGS = ("--mode", "async", "--compress-grad", "true", "--grad-codec",
               "int8lat", "--staleness-limit", "4", "--network", "ResNet18",
               "--dataset", "synthetic_cifar10", "--batch-size", "64",
               "--compute-dtype", "bfloat16", "--conv-impl", "pallas",
               "--fused-optimizer", "--momentum", "0.9", "--weight-decay",
               "5e-4", "--test-batch-size", "4167", "--kv-retry-attempts",
               "2", "--log-every", "4", "--max-steps", str(POISON_STEPS),
               "--eval-freq", "0", "--resume", "false", "--fault-spec",
               POISON_SPEC, "--device", "cuda")
# MAIN-HIER: the JAX hierarchy drill's partition phase
# (tools/hierarchy_drill.py:51-80, RESILIENCE_r14) on ResNet-18 at
# MAIN-POISON's width: four processes of batch 64 (global 256) in two
# groups of two, int8lat with error feedback, the group lease at 3 s, two
# KV attempts; kv_partition cuts group 1 (processes 2, 3) off the KV for
# HIER_WINDOW of their own steps from their step HIER_CUT. The root counts
# silence in leader versions and declares a partition after more than
# staleness_limit (4) of them, while the window counts the partitioned
# processes' own steps: on the card a follower takes ~3.75 steps a leader
# tick (MAIN-POISON), ~4.6 while cut off (the first card run: 28 steps
# spanned ~6 versions, the partition declared at 7 and the regraft at 8),
# so the drill's 12 steps would span ~3 versions and no partition would
# be declared. 40 steps span ~9 versions (13 at 3 steps a version), and
# 13 versions leave room for the regraft after the heal (on the card it
# came at version 8 to 10; 20 versions until MAIN-SERVE needed the time,
# 16 until MAIN-F16 did).
HIER_STEPS = 13
HIER_CUT = 6
HIER_WINDOW = 40
HIER_ARGS = ("--mode", "async", "--compress-grad", "true", "--grad-codec",
             "int8lat", "--ef", "--sync-topology", "hier",
             "--sync-group-size", "2", "--staleness-limit", "4",
             "--kv-retry-attempts", "2", "--leader-lease-s", "3",
             "--network", "ResNet18", "--dataset", "synthetic_cifar10",
             "--batch-size", "64", "--compute-dtype", "bfloat16",
             "--conv-impl", "pallas", "--fused-optimizer", "--momentum",
             "0.9", "--weight-decay", "5e-4", "--test-batch-size", "4167",
             "--log-every", "1", "--max-steps", str(HIER_STEPS),
             "--eval-freq", str(HIER_STEPS), "--resume", "false",
             "--fault-spec", f"kv_partition:group=1,gsize=2,step={HIER_CUT},"
             f"steps={HIER_WINDOW}", "--device", "cuda")
# MAIN-HIER's in-process leg: four slices of batch 64 in two groups, the
# same codec, 4 ticks uninterrupted against 2 ticks, a checkpoint and a
# resume to 4.
HIER_SLICE_ARGS = ("--mode", "async", "--async-slices", "4",
                   "--compress-grad", "true", "--grad-codec", "int8lat",
                   "--ef", "--sync-topology", "hier", "--sync-group-size",
                   "2", "--network", "ResNet18", "--dataset",
                   "synthetic_cifar10", "--batch-size", "64",
                   "--compute-dtype", "bfloat16", "--conv-impl", "pallas",
                   "--fused-optimizer", "--momentum", "0.9",
                   "--weight-decay", "5e-4", "--test-batch-size", "4167")
EVAL_RE = re.compile(r"^EVAL step (\d+) loss (\S+) prec1 (\S+) prec5 (\S+)$",
                     re.M)
EVAL_LM_RE = re.compile(r"^EVAL_LM step (\d+) loss (\S+) perplexity (\S+)$",
                        re.M)
# MAIN-LM8K: the JAX package's long-context row transformer_lm_8k_flash
# (bench_suite.py:1485-1490): the LM above at S 8192 and batch 1, f32,
# through train_lm.main (3 steps, a checkpoint at 3, FINAL over the first
# 8 of the validation tail's 12 windows of 8192), then evaluate.main
# --once 3 through the flash oracle, then the same checkpoint through the
# full-attention oracle on the card, whose [1, 8, 8192, 8192] f32 scores
# (2.15 GB a layer) fit at batch 1. Its attention call is [1, 8, 8192,
# 64], causal.
LM8K_STEPS, LM8K_FINAL_BATCHES = 3, 8
LM8K_ARGS = ("--lm-attention", "flash", "--lm-d-model", "512", "--lm-layers",
             "8", "--lm-heads", "8", "--lm-vocab", "32000", "--lm-seq-len",
             "8192", "--batch-size", "1", "--lr", "0.01", "--momentum",
             "0.9")
LM8K_FLASH_SHAPE = (1, 8, 8192, 64)
LM8K_FLASH_CASES = ((LM8K_FLASH_SHAPE, True, "float32"),)
# MAIN-LMCKPT: the full-width LM of LM_ARGS through the entry points, with
# remat and a corrupted checkpoint: 4 steps checkpointed every 2 (step 4
# corrupted), a resume that walks back to step 2 and trains to 6,
# evaluate.main --once 6, then greedy generate.main of 64 tokens. The
# validation tail of the 1M-token stream is 48 windows of 2048: 6 batches
# of 8, which train_lm's FINAL evaluation (up to 8 batches) runs.
LMCKPT_STEPS = 4
LMCKPT_RESUMED = 6
LM_FINAL_BATCHES = 6
LMCKPT_NEW = 64
# MAIN-LMDIST: the LM path's model as two gloo ranks sharing the card
# (NCCL refuses two ranks on one device), one launch, four runs in one
# process group (the fourth is MAIN-MOE, below), first sp over both ranks
# (ring attention, 1024 tokens a rank),
# tp over the model axis, and pp of 2 stages x 4 microbatches with its
# stages on the flash kernels under remat. Each run takes 3 steps and a
# checkpoint at 3; its step-1 loss and its parameters after 2 steps
# (gathered) are held against the one-rank LM on the same weights and
# batches (full attention for sp and tp, flash for pp) at the JAX parity
# tolerances (tests/test_tp.py:112-115, tests/test_pp.py:99-103).
LMDIST_STEPS = 3
LMDIST_HELD = 2
LMDIST_MICRO = 4
# MAIN-MOE is the fourth run: the JAX bench_suite.py row moe_lm_2k
# (bench_suite.py:341-391, 1491), the LM above with 8 switch experts in
# every block (top-1, capacity factor 1.25), ep over both ranks; its
# reference is the one-rank MoE in two capacity groups, the exact oracle
# of tests/test_ep.py:114-158, held at that test's tolerances. Then
# evaluate.main and greedy generate.main of MOE_NEW tokens on its
# checkpoint (moe_checks).
MOE_EXPERTS = 8
MOE_FLAGS = ("--lm-parallelism", "ep", "--lm-experts", str(MOE_EXPERTS),
             "--lm-attention", "flash")
MOE_NEW = 32
# The fifth, tp7: tp over the 2-rank model axis with 7 heads of 64 (d 448),
# which the axis does not divide: each rank's q/k/v columns straddle a
# head (parallel/tp.py gathers them), 2 steps, no checkpoint. Then, in
# the same launch, sp's step-3 checkpoint scored by evaluate.main on both
# ranks: the ring over them (LMDIST_EVAL).
ODD_HEADS = ("--lm-heads", "7", "--lm-d-model", "448")
LMDIST_RUNS = (
    ("sp", ("--lm-parallelism", "sp", "--lm-attention", "auto"),
     ("--lm-attention", "full")),
    ("tp", ("--lm-parallelism", "tp", "--lm-model-axis", "2",
            "--lm-attention", "full"), ("--lm-attention", "full")),
    ("pp", ("--lm-parallelism", "pp", "--lm-model-axis", "2",
            "--lm-microbatches", str(LMDIST_MICRO), "--lm-attention",
            "flash", "--remat"), ("--lm-attention", "flash")),
    ("ep", MOE_FLAGS, MOE_FLAGS),
    ("tp7", ("--lm-parallelism", "tp", "--lm-model-axis", "2",
             "--lm-attention", "full", *ODD_HEADS),
     ("--lm-attention", "full", *ODD_HEADS)))
LMDIST_RUN_STEPS = {"tp7": LMDIST_HELD}
LMDIST_EVAL = "--evaluate"
LMDIST_LOSS_TOL, LMDIST_RTOL, LMDIST_ATOL = 2e-5, 2e-4, 2e-5
LMDIST_TOLS = {"ep": (2e-5, 5e-4, 5e-5)}
# MAIN-SERVE: MAIN-LMCKPT's checkpoints of the full-width LM served
# (nothing new is trained). In process, 16 requests with prompts of 16 to
# 512 tokens and 32 new tokens each (64 until MAIN-LMDIST took the time),
# the even ones greedy, the odd ones
# sampled (temperature 0.8, top-k 40), through ServingEngine at 1, 4 and 8
# slots, every stream held token for token against generate (the logits
# compared at 4 and 8, the runs at 1 and 8 timed); then
# ``python -m ps_pytorch_tpu_torch.serve`` over HTTP (step 2, then a
# reload to step 6 past a corrupt step 8 while a request is in flight,
# SIGTERM), and a fleet of two replicas, replica 1 armed with
# replica_kill, behind an in-process Router.
SERVE_SLOTS = (1, 4, 8)
SERVE_COMPARED = (4, 8)
SERVE_TIMED = (1, 8)
SERVE_PROMPTS = tuple(int(x) for x in np.linspace(16, 512, 16))
SERVE_NEW = 32
SERVE_SPEC = "ttft_p99<30s;latency_p99<60s;availability>=99"
SERVE_FIRST_KEYS = ["serving", "metrics", "model_step", "slots", "vocab",
                    "seq_len", "replica_id", "slo_spec", "reqtrace_keep"]
# The reload lands while 8 requests of 1024 new tokens fill the 8 slots
# (on the card a tick took 6.5 ms and the reload 2.5 s).
SERVE_INFLIGHT = 8
SERVE_INFLIGHT_NEW = 1024
FLEET_REQUESTS = 24
FLEET_NEW = 16
FLEET_KILL_AFTER = 5
# ACCURACY-LM: the JAX package's ACCURACY_LM recipe (the port's
# tools/accuracy_run.py:lm_recipe) on the framework's own source bytes,
# with the flash kernels: 2000 steps, one checkpoint at 2000, scored by
# evaluate.main; perplexity at most 16 (ACCURACY_LM_r03's target).
ACC_LM_STEPS = 2000
ACC_LM_LAYERS = 2
ACC_LM_TARGET_PPL = 16.0
# The model's FLOPs a training step, the JAX package's count on the xla /
# full-attention route at each path's shapes (utils/flops.py), and the
# H100 SXM's dense bf16 peak that mfu divides by (NVIDIA's data sheet,
# 700 W), whatever the compute type, as the JAX package divides it.
FLOPS_A_STEP = {"MAIN": 852_223_328_256, "MAIN-TELEMETRY": 852_223_328_256,
                "MAIN-VGG": 234_624_122_880,
                "MAIN-IMAGENET": 3_110_281_936_896,
                "MAIN-LM": 5_733_781_340_160}
MFU_PEAK = 989e12
# MAIN-TELEMETRY: MAIN's ResNet-18 through train.run with every flag of
# the ops plane; 8333 test images make 2 eval batches of 4167.
TELEMETRY_STEPS = 8
TELEMETRY_ARGS = ("--network", "ResNet18", "--dataset", "synthetic_cifar10",
                  "--batch-size", str(BATCH), "--test-batch-size", "4167",
                  "--compute-dtype", "bfloat16", "--conv-impl", "pallas",
                  "--fused-optimizer", "--momentum", "0.9", "--weight-decay",
                  "5e-4", "--max-steps", str(TELEMETRY_STEPS),
                  "--eval-freq", str(TELEMETRY_STEPS), "--resume", "false",
                  "--profile-steps", "3-4", "--health-spec",
                  "nonfinite:halt;spike:warn,factor=10;stall:warn",
                  "--device", "cuda")
TELEMETRY_SPANS = ("data_wait", "host_dispatch", "device_sync",
                   "metrics_sync", "checkpoint", "checkpoint_write")


def fail(msg: str) -> None:
    print(f"FAIL {msg}", flush=True)
    sys.exit(1)


def kernel_name(ptxas_line: str) -> str:
    """``conv3x3_tc_kernel<f16,256,64>`` from ptxas's line naming a mangled
    entry function (template integers and bf16 / f16 / f32 only); the name
    as it stands where it is not a ``*_kernel`` one."""
    for m in re.finditer(r"(?=(\d+)([A-Za-z_]\w*))", ptxas_line):
        size, text = int(m.group(1)), m.group(2)
        name = text[:size]
        if len(name) == size and name.endswith("_kernel"):
            args = text[size:].split("Ev", 1)[0] + "E"
            if not args.startswith("I"):
                return name
            kinds = re.findall(r"Li(\d+)E|(__nv_bfloat16)|(__half)|I(f)E",
                               args)
            params = [n or ("bf16" if b else "f16" if h else "f32")
                      for n, b, h, _ in kinds]
            return f"{name}<{','.join(params)}>"
    found = re.search(r"entry function '(\w+)'", ptxas_line)
    return found.group(1) if found else ""


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20) -> float:
    """Device time of one call of ``fn``: ``iters`` calls captured in one
    CUDA graph and replayed, so the host's cost of each launch is out of
    the measurement (``time_ms`` over eager calls measures the host instead
    when a call launches faster kernels than the host can enqueue). The
    warm-up runs on the current stream: cuBLAS keeps a workspace for every
    stream it has run on."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    ms = time_ms(graph.replay, iters=5, warmup=1) / iters
    del graph                   # its memory pool, before the next phase
    torch.cuda.empty_cache()
    return ms


def host_us(fn, iters: int = 100) -> float:
    """Host time of one call of ``fn`` (what the Python side spends to
    enqueue it), on the host clock, the card drained first and after."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / iters


def conv_bound_ms(n, h, c, co, dtype_name) -> tuple:
    """(ms for the operations at peak, ms for the bytes at the memory
    rate) of one conv: each input read once, the output written once."""
    size = ELEMENT_BYTES[dtype_name]
    ops = 2.0 * n * h * h * c * co * 9
    nbytes = (n * h * h * c + 9 * c * co + n * h * h * co) * size
    return 1e3 * ops / PEAK_OPS[dtype_name], 1e3 * nbytes / HBM_BYTES_PER_S


def check_conv(torch, F, conv_mod) -> dict:
    """The conv3x3 kernels against their plain version, forward and input
    gradient, at the four ResNet-18 geometries, batch 256: f32 through the
    SIMT kernel, bf16 and f16 through the tensor-core kernel (its route is
    counted); the 16-bit rows also time the SIMT kernel on the same inputs,
    the kernel that route replaced. Returns one step's sums (26 launches)
    for bf16, and for f16 under ``"float16"``; an f16 view 2 bytes off a
    16-byte boundary takes the SIMT kernel."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    steps = {}
    for dtype_name in ("float32", "bfloat16", "float16"):
        dt = getattr(torch, dtype_name)
        tol = CONV_TOL[dtype_name]
        want_route = "simt" if dtype_name == "float32" else "tc"
        step = {"ms": 0.0, "simt_ms": 0.0, "plain_ms": 0.0,
                "library_ms": 0.0, "bound_ms": 0.0, "ops_ms": 0.0,
                "bytes_ms": 0.0, "max_abs_err": 0.0}
        for h, c, count in GEOMETRIES:
            x = torch.randn(BATCH, h, h, c, device="cuda", generator=gen)
            w = torch.randn(3, 3, c, c, device="cuda", generator=gen) \
                / math.sqrt(9 * c)
            x, w = x.to(dt), w.to(dt)
            wt = torch.flip(w, (0, 1)).transpose(2, 3).contiguous()
            for kind, fn, w_eff in (
                    ("fwd", conv_mod.conv3x3, w),
                    ("input_grad", conv_mod.conv3x3_input_grad, wt)):
                tc_before = conv_mod.conv3x3.tc_launches
                out = fn(x, w)
                route = "tc" if conv_mod.conv3x3.tc_launches > tc_before \
                    else "simt"
                if route != want_route:
                    fail(f"conv3x3 {kind} {dtype_name} {h}x{h}x{c} took the "
                         f"{route} kernel, expected {want_route}")
                ref = conv_mod.conv3x3_reference(x, w_eff)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                if not torch.allclose(out.float(), ref.float(), rtol=tol,
                                      atol=tol):
                    fail(f"conv3x3 {kind} {dtype_name} {h}x{h}x{c}: max abs "
                         f"err {err} above {tol}")
                # Times of the kernel alone (on w_eff, without the input
                # gradient's flip), device time from graph replays.
                x_cl = x.permute(0, 3, 1, 2)          # channels_last NCHW
                w_oihw = w_eff.permute(3, 2, 0, 1).contiguous()
                ms = graph_ms(lambda: conv_mod.conv3x3(x, w_eff))
                plain = graph_ms(
                    lambda: conv_mod.conv3x3_reference(x, w_eff), iters=3)
                lib = graph_ms(lambda: F.conv2d(x_cl, w_oihw, padding=1))
                ops_ms, bytes_ms = conv_bound_ms(BATCH, h, c, c, dtype_name)
                bound = max(ops_ms, bytes_ms)
                line = (f"KERNEL conv3x3 {kind} {dtype_name} {BATCH}x{h}x{h}x"
                        f"{c} route {route} ms {ms:.4f} plain_ms {plain:.4f} "
                        f"library_ms {lib:.4f} bound_ms {bound:.4f} "
                        f"max_abs_err {err:.3e}")
                if dtype_name != "float32":
                    simt = graph_ms(
                        lambda: conv_mod._launch(x, w_eff, "simt"), iters=3)
                    line += (f" simt_ms {simt:.4f} tflops "
                             f"{2 * 9 * BATCH * h * h * c * c / ms / 1e9:.1f}")
                    if kind == "fwd" and dtype_name == "bfloat16":
                        us = host_us(lambda: fn(x, w))
                        lib_us = host_us(
                            lambda: F.conv2d(x_cl, w_oihw, padding=1))
                        line += f" host_us {us:.1f} library_host_us " \
                                f"{lib_us:.1f}"
                    step["max_abs_err"] = max(step["max_abs_err"], err)
                    for key, value in (("ms", ms), ("simt_ms", simt),
                                       ("plain_ms", plain),
                                       ("library_ms", lib),
                                       ("bound_ms", bound),
                                       ("ops_ms", ops_ms),
                                       ("bytes_ms", bytes_ms)):
                        step[key] += count * value
                print(line, flush=True)
        if dtype_name != "float32":
            steps[dtype_name] = step
            print(f"KERNEL conv3x3 one step's {CONV_PER_STEP} launches "
                  f"({dtype_name}, batch {BATCH}, route tc): ms "
                  f"{step['ms']:.4f} simt_ms {step['simt_ms']:.4f} "
                  f"plain_ms {step['plain_ms']:.4f} library_ms "
                  f"{step['library_ms']:.4f} bound_ms "
                  f"{step['bound_ms']:.4f} ratio_to_library "
                  f"{step['ms'] / step['library_ms']:.3f}", flush=True)
    # An f16 view 2 bytes off a 16-byte boundary: route picks SIMT, which
    # computes it; nothing goes through the tensor cores.
    x = torch.randn(2, 8, 8, 16, device="cuda", generator=gen).half()
    w = (torch.randn(3, 3, 16, 16, device="cuda", generator=gen) / 12).half()
    odd = torch.empty(x.numel() + 1, dtype=torch.float16, device="cuda")[1:]
    odd = odd.view(x.shape).copy_(x)
    tc_before = conv_mod.conv3x3.tc_launches
    out = conv_mod.conv3x3(odd, w)
    err = (out.float() - conv_mod.conv3x3_reference(odd, w).float()) \
        .abs().max().item()
    if conv_mod.conv3x3.tc_launches != tc_before or \
            conv_mod.route(odd.dtype, 16, 16, odd.data_ptr(), w.data_ptr(),
                           out.data_ptr()) != "simt" \
            or err > CONV_TOL["float16"]:
        fail(f"conv3x3 f16 view off 16 bytes: route or result (max abs err "
             f"{err})")
    print(f"KERNEL conv3x3 fwd float16 2x8x8x16 view 2 bytes off 16 route "
          f"simt max_abs_err {err:.3e}", flush=True)
    return dict(steps["bfloat16"], float16=steps["float16"])


def check_conv_geometries(torch, F, conv_mod, label: str, batch: int,
                          geometries, dtype_name: str = "bfloat16") -> dict:
    """The tensor-core conv3x3 (bf16 or f16) against its plain version at
    a model's stride-1 geometries, forward (C -> Co) and input gradient
    (Co -> C), within the tolerance of ``check_conv``; every launch must
    take the tensor-core kernel. Times the kernel, the plain version and
    ``F.conv2d`` by graph replay beside the bound, and sums one step's
    launches (each geometry times its count)."""
    tol = CONV_TOL[dtype_name]
    dt = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(7)
    step = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
            "ops_ms": 0.0, "bytes_ms": 0.0}
    max_err, launches = 0.0, 0
    for h, c, co, count in geometries:
        x = torch.randn(batch, h, h, c, device="cuda", generator=gen)
        g = torch.randn(batch, h, h, co, device="cuda", generator=gen)
        w = torch.randn(3, 3, c, co, device="cuda", generator=gen) \
            / math.sqrt(9 * c)
        x, g, w = x.to(dt), g.to(dt), w.to(dt)
        wt = torch.flip(w, (0, 1)).transpose(2, 3).contiguous()
        for kind, fn, inp, w_eff in (
                ("fwd", conv_mod.conv3x3, x, w),
                ("input_grad", conv_mod.conv3x3_input_grad, g, wt)):
            tc_before = conv_mod.conv3x3.tc_launches
            out = fn(inp, w)
            if conv_mod.conv3x3.tc_launches != tc_before + 1:
                fail(f"conv3x3 {label} {kind} {h}x{h}x{c}->{co} did not take "
                     "the tensor-core kernel")
            ref = conv_mod.conv3x3_reference(inp, w_eff)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            if not torch.allclose(out.float(), ref.float(), rtol=tol,
                                  atol=tol):
                fail(f"conv3x3 {label} {kind} {dtype_name} {batch}x{h}x{h} "
                     f"{c}->{co}: max abs err {err} above {tol}")
            c_in, c_out = w_eff.shape[2], w_eff.shape[3]
            in_cl = inp.permute(0, 3, 1, 2)          # channels_last NCHW
            w_oihw = w_eff.permute(3, 2, 0, 1).contiguous()
            ms = graph_ms(lambda: conv_mod.conv3x3(inp, w_eff))
            plain = graph_ms(lambda: conv_mod.conv3x3_reference(inp, w_eff),
                             iters=3)
            lib = graph_ms(lambda: F.conv2d(in_cl, w_oihw, padding=1))
            ops_ms, bytes_ms = conv_bound_ms(batch, h, c_in, c_out,
                                             dtype_name)
            bound = max(ops_ms, bytes_ms)
            print(f"KERNEL conv3x3 {label} {kind} {dtype_name} "
                  f"{batch}x{h}x{h} {c_in}->{c_out} x{count} route tc ms "
                  f"{ms:.4f} plain_ms {plain:.4f} library_ms {lib:.4f} "
                  f"bound_ms {bound:.4f} "
                  f"ratio_to_library {ms / lib:.3f} tflops "
                  f"{2 * 9 * batch * h * h * c_in * c_out / ms / 1e9:.1f} "
                  f"max_abs_err {err:.3e}", flush=True)
            max_err = max(max_err, err)
            launches += count
            for key, value in (("ms", ms), ("plain_ms", plain),
                               ("library_ms", lib), ("bound_ms", bound),
                               ("ops_ms", ops_ms), ("bytes_ms", bytes_ms)):
                step[key] += count * value
    print(f"KERNEL conv3x3 {label} one step's {launches} launches "
          f"({dtype_name}, batch {batch}, route tc): ms {step['ms']:.4f} "
          f"plain_ms {step['plain_ms']:.4f} library_ms "
          f"{step['library_ms']:.4f} "
          f"bound_ms {step['bound_ms']:.4f} ratio_to_library "
          f"{step['ms'] / step['library_ms']:.3f}", flush=True)
    return dict(step, max_abs_err=max_err, launches_a_step=launches)


def time_weight_grad(torch, conv_mod) -> None:
    """The weight gradient's time in one ResNet-18 step: torch ops (a pad,
    9 tap copies and matmuls, a stack) at the four geometries, each times
    its count of convs, bf16, batch 256; device time from graph replays,
    and the host's time to enqueue one call. Then, at each geometry, the
    bf16 and f16 weight gradient with cuBLAS's reduced-precision reduction
    on and off."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    total, host, parts = 0.0, 0.0, []
    for h, c, count in GEOMETRIES:
        x = torch.randn(BATCH, h, h, c, device="cuda", generator=gen) \
            .bfloat16()
        g = torch.randn(BATCH, h, h, c, device="cuda", generator=gen) \
            .bfloat16()
        ms = graph_ms(lambda: conv_mod.conv3x3_weight_grad(x, g), iters=5)
        us = host_us(lambda: conv_mod.conv3x3_weight_grad(x, g), iters=20)
        total += count * ms
        host += count * us / 1e3
        parts.append(f"{h}x{h}x{c} {ms:.4f} x {count}")
    print(f"DW conv3x3_weight_grad one step's {CONV_PER_STEP // 2} calls "
          f"(bf16, batch {BATCH}): device ms {total:.4f} "
          f"({', '.join(parts)}); host ms to enqueue them {host:.4f}",
          flush=True)
    # The reference numerics turn off cuBLAS's reduced-precision reduction
    # of split-K partials in f16 and bf16 (the JAX conv's dW sums in f32):
    # what that costs and changes, in turns (on, off, off, on), against
    # the f32 weight gradient of the same 16-bit inputs.
    matmul = torch.backends.cuda.matmul
    for dt, flag in ((torch.bfloat16,
                      "allow_bf16_reduced_precision_reduction"),
                     (torch.float16,
                      "allow_fp16_reduced_precision_reduction")):
        kept, parts = getattr(matmul, flag), []
        for h, c, _ in GEOMETRIES:
            x = torch.randn(BATCH, h, h, c, device="cuda",
                            generator=gen).to(dt)
            g = torch.randn(BATCH, h, h, c, device="cuda",
                            generator=gen).to(dt)
            ref = conv_mod.conv3x3_weight_grad(x.float(), g.float())
            runs = []
            for on in (True, False, False, True):
                setattr(matmul, flag, on)
                rel = (conv_mod.conv3x3_weight_grad(x, g).float() - ref) \
                    .abs().max().item() / ref.abs().max().item()
                ms = graph_ms(lambda: conv_mod.conv3x3_weight_grad(x, g),
                              iters=5)
                runs.append(f"{'on' if on else 'off'} {ms:.4f} ms rel err "
                            f"{rel:.3e}")
            parts.append(f"{h}x{h}x{c} " + ", ".join(runs))
        setattr(matmul, flag, kept)
        print(f"DW {flag} ({dt}, batch {BATCH}, ms by graph replay, max "
              f"abs err over max |f32 dW|): {'; '.join(parts)}", flush=True)


def check_sgd(torch, sgd_mod, n: int) -> dict:
    """Kernel B against its plain version on n elements (ResNet-18's
    parameter count), 3 steps each, with and without Nesterov, weight
    decay and dampening."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    max_err = 0.0
    for nesterov, wd, damp in ((False, 0.0, 0.0), (True, 5e-4, 0.0),
                               (False, 5e-4, 0.1), (True, 0.0, 0.0)):
        kw = dict(momentum=0.9, dampening=damp, weight_decay=wd,
                  nesterov=nesterov)
        p = torch.randn(n, device="cuda", generator=gen)
        b = torch.zeros(n, device="cuda")
        p_ref, b_ref = p.clone(), b.clone()
        for k in range(3):
            g = torch.randn(n, device="cuda", generator=gen)
            sgd_mod.fused_sgd_update(p, b, g, 0.05, k == 0, **kw)
            sgd_mod.fused_sgd_reference(p_ref, b_ref, g, 0.05, k == 0, **kw)
            torch.cuda.synchronize()
            err = max((p - p_ref).abs().max().item(),
                      (b - b_ref).abs().max().item())
            max_err = max(max_err, err)
            if not (torch.allclose(p, p_ref, rtol=1e-6, atol=1e-6)
                    and torch.allclose(b, b_ref, rtol=1e-6, atol=1e-6)):
                fail(f"fused_sgd {kw} step {k}: max abs err {err} above 1e-6")
        print(f"CHECK fused_sgd {kw}: 3 steps, max abs err {err:.3e}",
              flush=True)
    # Timing on the main path's settings (momentum 0.9, wd 5e-4), a step
    # after the first: reads p, buf, g and writes p, buf.
    kw = dict(momentum=0.9, dampening=0.0, weight_decay=5e-4, nesterov=False)
    p = torch.randn(n, device="cuda", generator=gen)
    b = torch.randn(n, device="cuda", generator=gen)
    g = torch.randn(n, device="cuda", generator=gen) * 1e-3
    ms = time_ms(lambda: sgd_mod.fused_sgd_update(p, b, g, 1e-3, False, **kw))
    plain = time_ms(lambda: sgd_mod.fused_sgd_reference(p, b, g, 1e-3, False,
                                                        **kw))
    param = torch.nn.Parameter(p.clone())
    param.grad = g.clone()
    lib_opt = torch.optim.SGD([param], lr=1e-3, momentum=0.9,
                              weight_decay=5e-4, fused=True)
    lib_opt.step()
    lib = time_ms(lib_opt.step)
    bound = 1e3 * 20.0 * n / HBM_BYTES_PER_S
    print(f"KERNEL fused_sgd {n} params ms {ms:.4f} plain_ms {plain:.4f} "
          f"library_ms {lib:.4f} bound_ms {bound:.4f} max_abs_err "
          f"{max_err:.3e}", flush=True)
    return {"ms": ms, "plain_ms": plain, "library_ms": lib,
            "bound_ms": bound, "max_abs_err": max_err}


def check_adam(torch, adam_mod, n: int) -> dict:
    """The fused-Adam kernel against its plain version, 3 steps each,
    without and with weight decay and AMSGrad, on one element, on a size
    that is not a multiple of the block and on n (ResNet-18's parameter
    count); then timed at n on the main path's settings."""
    from ps_pytorch_tpu_torch.optim.adam import adam_step_size
    gen = torch.Generator(device="cuda").manual_seed(3)
    max_err = 0.0
    for wd, amsgrad in ((0.0, False), (5e-4, False), (5e-4, True)):
        kw = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=wd)
        for size in (1, 100_003, n):
            p = torch.randn(size, device="cuda", generator=gen)
            bufs = [torch.zeros_like(p) for _ in range(3 if amsgrad else 2)]
            ref = [p.clone()] + [b.clone() for b in bufs]
            for t in range(1, 4):
                g = torch.randn(size, device="cuda", generator=gen)
                ss = adam_step_size(1e-3, 0.9, 0.999, t)
                adam_mod.fused_adam_update(p, bufs[0], bufs[1], bufs[2] if
                                           amsgrad else None, g, ss, **kw)
                adam_mod.fused_adam_reference(ref[0], ref[1], ref[2], ref[3]
                                              if amsgrad else None, g, ss,
                                              **kw)
            torch.cuda.synchronize()
            err = max((a - b).abs().max().item()
                      for a, b in zip([p] + bufs, ref))
            max_err = max(max_err, err)
            if not all(torch.allclose(a, b, rtol=1e-6, atol=1e-7)
                       for a, b in zip([p] + bufs, ref)):
                fail(f"fused_adam wd {wd} amsgrad {amsgrad} size {size}: "
                     f"max abs err {err} above rtol 1e-6, atol 1e-7")
            print(f"CHECK fused_adam wd {wd} amsgrad {amsgrad} size {size}: "
                  f"3 steps, max abs err {err:.3e}", flush=True)
    # Timing on the main path's settings (wd 5e-4, no AMSGrad): reads p, m,
    # v, g and writes p, m, v.
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=5e-4)
    p, m, g = (torch.randn(n, device="cuda", generator=gen) for _ in range(3))
    v = torch.rand(n, device="cuda", generator=gen)
    ss = adam_step_size(1e-3, 0.9, 0.999, 10)
    ms = time_ms(lambda: adam_mod.fused_adam_update(p, m, v, None, g, ss,
                                                    **kw))
    plain = time_ms(lambda: adam_mod.fused_adam_reference(p, m, v, None, g,
                                                          ss, **kw))
    param = torch.nn.Parameter(p.clone())
    param.grad = g.clone()
    lib_opt = torch.optim.Adam([param], lr=1e-3, weight_decay=5e-4,
                               fused=True)
    lib_opt.step()
    lib = time_ms(lib_opt.step)
    bound = 1e3 * 28.0 * n / HBM_BYTES_PER_S
    print(f"KERNEL fused_adam {n} params ms {ms:.4f} plain_ms {plain:.4f} "
          f"library_ms {lib:.4f} bound_ms {bound:.4f} max_abs_err "
          f"{max_err:.3e}", flush=True)
    return {"ms": ms, "plain_ms": plain, "library_ms": lib,
            "bound_ms": bound, "max_abs_err": max_err}


def flash_bound_ms(name, bh, s, d, causal, dtype_name) -> tuple:
    """(ms for the operations at the input type's peak, ms for the bytes,
    ms for the operations at the route's own rate) of one launch: each
    matmul of the kernel costs 2 d operations a (query, key) pair it
    reaches (the causal lower triangle only); the bytes read every input
    once and write every output once. The route's rate: the f32 kernels
    run 3xTF32 on the tensor cores, three TF32 operations for each f32
    one; bf16 and f16 at their peak."""
    size = ELEMENT_BYTES[dtype_name]
    pairs = bh * (s * (s + 1) // 2 if causal else s * s)
    ops = 2.0 * d * FLASH_MATMULS[name] * pairs
    tensors = {"flash_fwd": 4, "flash_dq": 5, "flash_dkv": 6}[name]
    rows = {"flash_fwd": 1, "flash_dq": 2, "flash_dkv": 2}[name]  # lse, delta
    nbytes = tensors * bh * s * d * size + rows * bh * s * 4
    ops_ms = 1e3 * ops / PEAK_OPS[dtype_name]
    route_ms = 1e3 * 3 * ops / TF32_OPS if dtype_name == "float32" \
        else ops_ms
    return ops_ms, 1e3 * nbytes / HBM_BYTES_PER_S, route_ms


def check_flash(torch, F, fa, cases=FLASH_CASES,
                timed_shape=FLASH_SHAPE) -> dict:
    """The three flash kernels against their plain versions at ``cases``
    (``FLASH_CASES``), each launch's route read from the tensor-core
    counts; timed, with SDPA beside them, at ``timed_shape`` (the LM's).
    Returns the f32 figures of each kernel, and its f16 ones under
    ``"float16"``."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    out = {name: {"max_abs_err": 0.0, "float16": {"max_abs_err": 0.0}}
           for name in FLASH_MATMULS}
    fns = {"flash_fwd": fa.flash_fwd, "flash_dq": fa.flash_dq,
           "flash_dkv": fa.flash_dkv}
    for (b, h, s, d), causal, dtype_name in cases:
        dt = getattr(torch, dtype_name)
        bh, scale = b * h, d ** -0.5
        q, k, v, do = (torch.randn(bh, s, d, device="cuda", generator=gen)
                       .to(dt) for _ in range(4))
        o_ref, lse_ref = fa.flash_attention_reference(q, k, v, causal, scale)
        delta = (do.float() * o_ref.float()).sum(-1, keepdim=True)
        args = (q, k, v, do, lse_ref, delta, causal, scale)
        tc_before = {name: fn.tc_launches for name, fn in fns.items()}
        o, lse = fa.flash_fwd(q, k, v, causal, scale)
        got = {"flash_fwd": (o, lse), "flash_dq": (fa.flash_dq(*args),),
               "flash_dkv": fa.flash_dkv(*args)}
        routes = {}
        for name, fn in fns.items():
            routes[name] = "tc" if fn.tc_launches == tc_before[name] + 1 \
                else "simt"
            if routes[name] != "tc":
                fail(f"{name} {b}x{h}x{s}x{d}: launched no tensor-core "
                     "kernel")
        want = {"flash_fwd": (o_ref, lse_ref),
                "flash_dq": (fa.flash_dq_reference(*args),),
                "flash_dkv": fa.flash_dkv_reference(*args)}
        torch.cuda.synchronize()
        fwd_tol, grad_tol = FLASH_TOL[dtype_name]
        kind = f"{'causal' if causal else 'full'} {dtype_name} {b}x{h}x{s}x{d}"
        timed = (b, h, s, d) == timed_shape
        if timed:
            # SDPA under torch's default flags, not the deterministic cuDNN
            # that the trainers leave set.
            deterministic = torch.backends.cudnn.deterministic
            torch.backends.cudnn.deterministic = False
            q4, k4, v4 = (t.view(b, h, s, d) for t in (q, k, v))
            lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=causal, scale=scale), iters=10)
            leaves = [t.detach().requires_grad_(True) for t in (q4, k4, v4)]
            o4 = F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                                scale=scale)
            lib_bwd = time_ms(lambda: torch.autograd.grad(
                o4, leaves, do.view(b, h, s, d), retain_graph=True), iters=10)
            torch.backends.cudnn.deterministic = deterministic
        for name in FLASH_MATMULS:
            tol = fwd_tol if name == "flash_fwd" else grad_tol
            err = 0.0
            for g, w in zip(got[name], want[name]):
                err = max(err, (g.float() - w.float()).abs().max().item())
                t = 2e-5 if g.dtype == torch.float32 and name == "flash_fwd" \
                    else tol
                if not torch.allclose(g.float(), w.float(), rtol=t, atol=t):
                    fail(f"{name} {kind}: max abs err {err} above {t}")
            if dtype_name in ("float32", "float16"):
                rec = out[name] if dtype_name == "float32" \
                    else out[name]["float16"]
                rec["max_abs_err"] = max(rec["max_abs_err"], err)
            line = (f"KERNEL {name} {kind} route {routes[name]} "
                    f"max_abs_err {err:.3e}")
            if timed:
                fn = {"flash_fwd": lambda: fa.flash_fwd(q, k, v, causal,
                                                        scale),
                      "flash_dq": lambda: fa.flash_dq(*args),
                      "flash_dkv": lambda: fa.flash_dkv(*args)}[name]
                ref = {"flash_fwd": lambda: fa.flash_attention_reference(
                    q, k, v, causal, scale),
                       "flash_dq": lambda: fa.flash_dq_reference(*args),
                       "flash_dkv": lambda: fa.flash_dkv_reference(*args)
                       }[name]
                ms = time_ms(fn, iters=10)
                plain = time_ms(ref, iters=3, warmup=1)
                lib = lib_fwd if name == "flash_fwd" else lib_bwd
                ops_ms, bytes_ms, route_ms = flash_bound_ms(
                    name, bh, s, d, causal, dtype_name)
                line += (f" ms {ms:.4f} plain_ms {plain:.4f} library_ms "
                         f"{lib:.4f} bound_ms {max(ops_ms, bytes_ms):.4f} "
                         f"(ops {ops_ms:.4f}, bytes {bytes_ms:.4f}) "
                         f"bound_tc_ms {max(route_ms, bytes_ms):.4f}")
                figures = dict(
                    ms=ms, plain_ms=plain, library_ms=lib,
                    bound_ms=max(ops_ms, bytes_ms),
                    bound_by=("operations" if ops_ms >= bytes_ms
                              else "bytes"))
                if dtype_name == "float32":
                    out[name].update(figures,
                                     bound_tc_ms=max(route_ms, bytes_ms))
                elif dtype_name == "float16":
                    out[name]["float16"].update(figures)
            print(line, flush=True)
    print("KERNEL flash library_ms: SDPA forward for flash_fwd, SDPA's whole "
          "backward (dq, dk and dv together) for flash_dq and flash_dkv; "
          "bound_tc_ms: the operations at the route's own rate (f32: "
          "3xTF32, three TF32 operations at 495 TFLOP/s for each f32 one)",
          flush=True)
    return out


def quantize_bound_ms(tq, sizes, injected: bool) -> float:
    """Bytes of one tree launch over 3.35 TB/s: each f32 element read once
    (and its noise, when the caller gives it), each padded int8 written
    once, a scale a block, and the leaf table and block map."""
    rows = [tq.padded_rows(n) for n in sizes]
    nbytes = sum(4 * n for n in sizes) + sum(
        (1 + 4 * injected) * r * tq.LANES + 12 * r // tq.BLOCK_ROWS
        for r in rows) + 48 * len(sizes)
    return 1e3 * nbytes / HBM_BYTES_PER_S


def check_quantize(torch, tq, leaf_sizes) -> dict:
    """The tree quantizer against its plain version: values and scales
    BITWISE, with the noise drawn in the kernel (Philox) and with the
    caller's, for ``QUANT_SIZES`` as one tree in f32 and in bf16 (an
    all-zero block and a block holding one huge value where the size
    allows) and for ResNet-18's gradient tree (``leaf_sizes``); the
    dequantized error at most one quantum and the mean of 256 draws under
    256 keys within a quarter quantum; then timed over the ResNet-18 tree
    in both modes: the kernel's device time (CUDA-graph replay of the
    launch), the whole call's (table built and copied on the host), the
    plain version and the bound."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    key = (1, 17)

    def noise_for(xs):
        return [torch.rand((tq.padded_rows(x.numel()), tq.LANES),
                           device="cuda", generator=gen) for x in xs]

    def tree_of(sizes, dtype_name):
        xs = []
        for n in sizes:
            x = torch.randn(n, device="cuda", generator=gen) * 0.02
            if n > 2 * tq.BLOCK:
                x[:tq.BLOCK] = 0.0                  # scale 1e-30, zeros
                x[tq.BLOCK + 7] = 3e38              # one huge value
            xs.append(x.to(getattr(torch, dtype_name)))
        return xs

    max_err = 0.0
    for label, dtype_name, sizes in (
            ("QUANT_SIZES", "float32", QUANT_SIZES),
            ("QUANT_SIZES", "bfloat16", QUANT_SIZES),
            ("ResNet-18 gradient tree", "float32", leaf_sizes)):
        xs = tree_of(sizes, dtype_name)
        for mode, noise in (("philox", None), ("injected", noise_for(xs))):
            before = tq.quantize_int8.launches
            got = tq.quantize_tree(xs, key, noise)
            if tq.quantize_int8.launches != before + 1:
                fail(f"quantize tree {label}: not one launch")
            want = tq.quantize_tree_reference(xs, key, noise)
            torch.cuda.synchronize()
            err = 0.0
            for x, a, b in zip(xs, got, want):
                err = max(err, (a.values.int() - b.values.int()).abs().max()
                          .item(), (a.scales - b.scales).abs().max().item())
                if not (torch.equal(a.values, b.values)
                        and torch.equal(a.scales, b.scales)):
                    fail(f"quantize {label} {dtype_name} {mode} n="
                         f"{x.numel()}: kernel and plain version differ "
                         f"(max abs {err}); they must be bitwise equal")
                back = tq.dequantize_int8(a)
                quantum = a.scales.repeat_interleave(tq.BLOCK)[:x.numel()]
                if not bool(((back - x.float()).abs()
                             <= quantum * (1 + 1e-6)).all()):
                    fail(f"quantize {label} {dtype_name} {mode} n="
                         f"{x.numel()}: dequantized error above one quantum")
                if x.numel() > 2 * tq.BLOCK and label == "QUANT_SIZES" and (
                        a.values[:tq.BLOCK_ROWS].any()
                        or not 0 < float(a.scales[0]) < 1.1e-30):
                    fail(f"quantize {dtype_name} n={x.numel()}: the all-zero "
                         "block")
            max_err = max(max_err, float(err))
            print(f"CHECK quantize tree {label} {dtype_name} noise {mode}: "
                  f"{len(xs)} leaves, {sum(sizes)} elements in one launch, "
                  f"values and scales bitwise equal, max abs err {err:.1e}",
                  flush=True)
    # Unbiased: one draw errs by at most half a quantum in standard
    # deviation, so the mean of 256 draws has at most 1/32 and the limit of
    # a quarter quantum is 8 of them (with the reference's 64 draws it is
    # 4, which 100,003 elements exceed by chance).
    x = torch.randn(100_003, device="cuda", generator=gen) * 0.1
    acc = torch.zeros_like(x)
    for step in range(256):
        qt = tq.quantize_tree([x], (0, step))[0]
        acc += tq.dequantize_int8(qt)
    quantum = qt.scales.repeat_interleave(tq.BLOCK)[:x.numel()]
    bias = ((acc / 256 - x).abs() / quantum).max().item()
    if not bias <= 0.25:
        fail(f"quantize: mean of 256 draws off by {bias} quanta (limit 0.25)")
    print(f"CHECK quantize unbiased (Philox noise, 256 keys): mean of 256 "
          f"draws within {bias:.3f} quantum (limit 0.25)", flush=True)

    xs = tree_of(leaf_sizes, "float32")
    out = {}
    for mode, noise in (("philox", None), ("injected", noise_for(xs))):
        plan = tq._plan(xs, noise)
        ms = graph_ms(lambda: tq._launch(plan, key))
        call = time_ms(lambda: tq.quantize_tree(xs, key, noise))
        plain = time_ms(lambda: tq.quantize_tree_reference(xs, key, noise),
                        iters=5)
        bound = quantize_bound_ms(tq, leaf_sizes, mode == "injected")
        out[mode] = {"ms": ms, "call_ms": call, "plain_ms": plain,
                     "bound_ms": bound}
        print(f"KERNEL quantize gradient tree noise {mode} (1 launch, "
              f"{len(xs)} leaves, {sum(leaf_sizes)} elements) ms {ms:.4f} "
              f"call_ms {call:.4f} plain_ms {plain:.4f} library_ms none (no "
              f"single PyTorch call floors x/scale + noise into int8 with a "
              f"scale per block) bound_ms {bound:.4f} (bytes)", flush=True)
    return dict(out["philox"], max_abs_err=max_err,
                injected_ms=out["injected"]["ms"],
                injected_call_ms=out["injected"]["call_ms"],
                injected_bound_ms=out["injected"]["bound_ms"])


def read_jsonl(path) -> list:
    return [json.loads(line) for line in Path(path).read_text().splitlines()]


def async_main_path(torch, wrappers, n_params: int) -> dict:
    """Full-width ResNet-18 trained by 2 asynchronous slices through
    ``train.main --mode async`` with the int8 codec; then a mixed-rate
    schedule whose stale gradients are used; then a run that leaves one
    slice pooled (K-of-N), writes a compressed checkpoint, resumes from it
    and is scored by ``evaluate.main``. Counts launches of the first."""
    from ps_pytorch_tpu_torch import compression, evaluate, train
    from ps_pytorch_tpu_torch.config import config_from_args
    from ps_pytorch_tpu_torch.ops import quantize as tq
    from ps_pytorch_tpu_torch.runtime import MultiSliceTrainer
    from ps_pytorch_tpu_torch.runtime import checkpoint as ckpt
    from ps_pytorch_tpu_torch.runtime.metrics import parse_line

    root = tempfile.mkdtemp(prefix="chip_smoke_async_")
    try:
        # 1. The command a user runs.
        torch.cuda.reset_peak_memory_stats()
        zero_counts(wrappers)
        t0 = time.monotonic()
        out = run_entry(train.main, [
            *ASYNC_ARGS, "--max-steps", str(ASYNC_TICKS), "--eval-freq", "0",
            "--resume", "false", "--train-dir", f"{root}/main",
            "--metrics-file", f"{root}/main.jsonl", "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = read_counts(wrappers)
        recs = [parse_line(ln) for ln in out.splitlines()
                if ln.startswith("STEP")]
        rows = read_jsonl(f"{root}/main.jsonl")
        if "SLICES 2 x 1 devices" not in out or "FINAL loss " not in out:
            fail("MAIN-ASYNC: train.main printed no SLICES or FINAL line")
        if [r["step"] for r in recs] != list(range(1, ASYNC_TICKS + 1)) \
                or not all(math.isfinite(r["loss"]) and r["participating"]
                           == 2 for r in recs):
            fail(f"MAIN-ASYNC: expected {ASYNC_TICKS} STEP lines with finite "
                 "loss and 2 participating slices")
        if [r["applied"] for r in rows] != list(range(1, ASYNC_TICKS + 1)) \
                or any(r["dropped_stale"] for r in rows):
            fail(f"MAIN-ASYNC: applied/dropped_stale {rows}")
        final = re.search(r"^FINAL loss (\S+) prec1 (\S+) prec5 (\S+)$", out,
                          re.M)
        if not final or not all(math.isfinite(float(v))
                                for v in final.groups()):
            fail("MAIN-ASYNC: no finite FINAL line")
        print(f"MAIN-ASYNC ticks {ASYNC_TICKS} slices 2 tick_times_s "
              f"{[r['step_time'] for r in rows]} train_main_s {wall:.2f} "
              f"max_memory_allocated {torch.cuda.max_memory_allocated()} "
              f"pool_wire_bytes {[r['pool_wire_bytes'] for r in rows]} "
              f"(used contributions are consumed before the line is "
              f"written) launches {launches}", flush=True)
        want = want_counts(wrappers, quantize=ASYNC_TICKS * 2,
                           conv3x3=CONV_PER_STEP * 2 * ASYNC_TICKS
                           + CONV_PER_EVAL_BATCH * 2, fused_sgd=ASYNC_TICKS)
        if launches != want:
            fail(f"MAIN-ASYNC launches {launches}, expected {want}")

        # 2. Slice 1 at half rate, fetching every 2 of its steps: its stale
        # gradients are used, none is dropped.
        cfg = config_from_args([*ASYNC_ARGS, "--eval-freq", "0", "--resume",
                                "false", "--train-dir", f"{root}/sched"])
        tr = MultiSliceTrainer(cfg, n_slices=2, slice_periods=[1, 2],
                               fetch_every=2, device="cuda",
                               printer=lambda line: None)
        used, stale_used = {0: 0, 1: 0}, 0
        for _ in range(8):
            info = tr.tick()
            for sid in info["used"]:
                used[sid] += 1
            stale_used += sum(tr._slice_version[sid] < tr.step - 1
                              for sid in info["used"])
            if not math.isfinite(info["loss"]):
                fail("MAIN-ASYNC schedule: loss is not finite")
        print(f"MAIN-ASYNC schedule periods [1, 2] fetch_every 2: used "
              f"{used} stale_but_used {stale_used} applied {tr.applied} "
              f"dropped_stale {tr.dropped_stale}", flush=True)
        if used[0] != 8 or used[1] < 3 or tr.dropped_stale != 0 \
                or tr.applied != 8 or stale_used < 1:
            fail("MAIN-ASYNC schedule: the slow slice's stale gradients "
                 "were not used as the schedule predicts")
        del tr
        async_tick_breakdown(torch, config_from_args(
            [*ASYNC_ARGS, "--eval-freq", "0", "--resume", "false",
             "--train-dir", f"{root}/parts"]))

        # 3. K-of-N (the freshest 1 of 2: slice 1 stays pooled), compressed
        # checkpoints every 2 ticks, resume, evaluator.
        td = f"{root}/td"
        ck_args = [*ASYNC_ARGS, "--num-aggregate", "1", "--eval-freq", "2",
                   "--train-dir", td, "--device", "cuda"]
        run_entry(train.main, [*ck_args, "--max-steps", "4",
                               "--metrics-file", f"{root}/ck.jsonl"])
        rows = read_jsonl(f"{root}/ck.jsonl")
        wire = {r["pool_wire_bytes"] for r in rows}
        share = max(wire) / (4.0 * n_params)
        print(f"MAIN-ASYNC K-of-N pool_wire_bytes {sorted(wire)} = "
              f"{share:.4f} of the f32 tree's {4 * n_params} bytes; "
              f"participating {[r['participating'] for r in rows]}",
              flush=True)
        if len(wire) != 1 or not 0.25 <= share <= 0.28 or any(
                r["participating"] != 1 for r in rows):
            fail("MAIN-ASYNC K-of-N: the pooled slice's int8 tree is not "
                 "about a quarter of the f32 tree")
        if ckpt.committed_steps(td) != [2, 4] or not all(
                ckpt.verify_checkpoint(td, k) for k in (2, 4)):
            fail(f"MAIN-ASYNC: checkpoints {ckpt.committed_steps(td)}")
        meta = json.loads(Path(ckpt.checkpoint_path(td, 4), "meta.json")
                          .read_text())
        blob = Path(ckpt.checkpoint_path(td, 4), "state.msgpack").read_bytes()
        if meta != {"step": 4, "compressed": True} or blob[:4] != b"PSC1":
            fail(f"MAIN-ASYNC: checkpoint 4 is not compressed ({meta})")
        print(f"MAIN-ASYNC checkpoint codec {compression.codec_name()} "
              f"state_bytes {len(blob)} ({len(blob) / (8.0 * n_params):.3f} "
              "of the f32 parameters and momentum)", flush=True)
        out = run_entry(train.main, [*ck_args, "--max-steps", "6"])
        if f"RESUME from {ckpt.checkpoint_path(td, 4)} at step 4" not in out \
                or [int(x) for x in re.findall(r"^STEP (\d+) ", out, re.M)] \
                != [5, 6]:
            fail("MAIN-ASYNC: the second run did not resume at step 4")
        found = EVAL_RE.findall(run_entry(
            evaluate.main, ["--train-dir", td, "--once", "4"]))
        if len(found) != 1 or found[0][0] != "4" or not all(
                math.isfinite(float(x)) for x in found[0][1:]):
            fail("MAIN-ASYNC: evaluate.main printed no finite EVAL step 4")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    multi_device_slices_agree(torch, wrappers)
    return launches


# Slices of two devices a slice (the JAX trainer's device groups) on the
# one card: LeNet on synthetic MNIST, int8 codec and fused SGD, held
# against the same trainer on the CPU (whose slices are CPU devices).
SLICES_TICKS = 3
SLICES_CFG = dict(network="LeNet", dataset="synthetic_mnist", batch_size=64,
                  lr=0.05, momentum=0.9, compute_dtype="float32",
                  mode="async", eval_freq=0, fused_optimizer=True,
                  compress_grad=True, grad_codec="int8", resume=False)


def multi_device_slices_agree(torch, wrappers) -> None:
    """MAIN-ASYNC's slices of several devices: ``MultiSliceTrainer(devices=
    ["cuda:0"] * 4, n_slices=2)``, two replicas a slice on the card, 3
    ticks, against ``devices=["cpu"] * 4`` from the same seed. The int8
    noise is the same Philox draw on both (the kernel's and its plain
    version's), so the ``used`` lists must be equal, the tick losses
    within 1e-4 and the parameters within 1e-3; the card quantizes each
    slice's averaged tree in one launch and applies each tick's update
    in one fused SGD launch."""
    from ps_pytorch_tpu_torch.config import TrainConfig
    from ps_pytorch_tpu_torch.runtime import MultiSliceTrainer

    runs = {}
    for dev in ("cuda", "cpu"):
        zero_counts(wrappers)
        tr = MultiSliceTrainer(TrainConfig(**SLICES_CFG), n_slices=2,
                               devices=[torch.device(dev, 0)] * 4,
                               device=dev, printer=lambda line: None)
        t0 = time.monotonic()
        infos = [tr.tick() for _ in range(SLICES_TICKS)]
        wall = time.monotonic() - t0
        runs[dev] = ([i["used"] for i in infos], [i["loss"] for i in infos],
                     {k: v.detach().cpu() for k, v
                      in tr.model.state_dict().items()},
                     read_counts(wrappers), tr.per, wall)
        del tr
    (uc, lc, sc, counts, per, wall), (up, lp, sp, _, _, _) = \
        runs["cuda"], runs["cpu"]
    want = want_counts(wrappers, quantize=2 * SLICES_TICKS,
                       fused_sgd=SLICES_TICKS)
    worst = max((sc[k] - sp[k]).abs().max().item() for k in sc)
    print(f"MAIN-ASYNC slices of {per} devices (2 x {per} on cuda:0) card "
          f"vs CPU: used {uc} / {up} losses {lc} / {lp} max abs weight "
          f"diff {worst:.3e} card ticks {wall:.2f} s launches "
          f"{counts}", flush=True)
    if per != 2 or uc != up or not np.allclose(lc, lp, rtol=1e-4,
                                               atol=1e-4) or worst > 1e-3:
        fail("MAIN-ASYNC: slices of two devices on the card disagree with "
             "the CPU")
    if counts != want:
        fail(f"MAIN-ASYNC slices of two devices: launches {counts}, "
             f"expected {want}")


def async_tick_breakdown(torch, cfg) -> None:
    """Where a tick's time goes: 2 warm-up ticks, then 3 ticks taken apart
    into the trainer's own phases, each ended by a synchronize and timed on
    the host clock, so a phase holds its device time and its host time.
    The sum exceeds a real tick only by the extra synchronizes."""
    from ps_pytorch_tpu_torch.runtime import MultiSliceTrainer

    tr = MultiSliceTrainer(cfg, n_slices=2, device="cuda",
                           printer=lambda line: None)
    for _ in range(2):
        tr.tick()
    torch.cuda.synchronize()
    parts = {k: 0.0 for k in ("fetch", "batch", "forward_backward",
                              "submit_quantize", "collect_dequantize_average",
                              "update")}
    ticks = 3

    def timed(name, fn):
        t0 = time.monotonic()
        out = fn()
        torch.cuda.synchronize()
        parts[name] += time.monotonic() - t0
        return out

    t_all = time.monotonic()
    for _ in range(ticks):
        tr.step += 1
        for s in range(2):
            timed("fetch", lambda: tr._fetch(s))
            x, y = timed("batch", tr.train_loaders[s].next_batch)
            grads, _ = timed("forward_backward", lambda: tr.grad_fns[s](x, y))
            timed("submit_quantize",
                  lambda: tr.aggregator.submit(s, tr.step - 1, grads))
        avg, pool = timed("collect_dequantize_average",
                          lambda: tr.aggregator.collect(tr.step - 1))

        def update():
            with torch.no_grad():
                tr.opt_state = tr.opt.apply(tr.params, tr.opt_state, avg)
            tr.aggregator.consume(pool["used"])

        timed("update", update)
    total = time.monotonic() - t_all
    print("MAIN-ASYNC breakdown ms a tick (2 slices, each phase ended by a "
          "synchronize): " + " ".join(
              f"{k} {1e3 * v / ticks:.2f}" for k, v in parts.items())
          + f" sum {1e3 * sum(parts.values()) / ticks:.2f} wall "
          f"{1e3 * total / ticks:.2f}", flush=True)


def small_async_tick_agrees(torch, tq) -> None:
    """LeNet, 2 slices, int8 codec, fused SGD: 2 ticks on the card and on
    the CPU from the same weights, batches and injected rounding noise.
    Losses agree at rtol 1e-3; parameters at atol 1e-3: sums run in another
    order on the card, and a quotient that lands on the other side of an
    integer moves that element by one quantum (about 1% of the leaf's
    largest gradient) times the learning rate."""
    from ps_pytorch_tpu_torch.config import TrainConfig
    from ps_pytorch_tpu_torch.runtime import MultiSliceTrainer

    def noise_fn(slice_id, step, leaf_index, shape):
        rng = np.random.default_rng((slice_id, step, leaf_index))
        return torch.from_numpy(rng.random(shape, dtype=np.float32))

    runs = {}
    before = tq.quantize_int8.launches
    for dev in ("cuda", "cpu"):
        cfg = TrainConfig(
            network="LeNet", dataset="synthetic_mnist", batch_size=64,
            lr=0.05, momentum=0.9, compute_dtype="float32", mode="async",
            eval_freq=0, fused_optimizer=True, compress_grad=True,
            grad_codec="int8", resume=False)
        tr = MultiSliceTrainer(cfg, n_slices=2, device=dev,
                               printer=lambda line: None, noise_fn=noise_fn)
        losses = [tr.tick()["loss"] for _ in range(2)]
        runs[dev] = (losses, {k: v.detach().cpu() for k, v
                              in tr.model.state_dict().items()})
    if tq.quantize_int8.launches != before + 2 * 2:
        fail("small async tick: the card run did not quantize each tree in "
             "one launch of the kernel")
    (lc, sc), (lp, sp) = runs["cuda"], runs["cpu"]
    if not np.allclose(lc, lp, rtol=1e-3, atol=1e-4):
        fail(f"small async tick: losses on the card {lc} vs CPU {lp}")
    worst = max((sc[k] - sp[k]).abs().max().item() for k in sc)
    if worst > 1e-3:
        fail(f"small async tick: weights differ between card and CPU by "
             f"{worst}")
    print(f"CHECK small async tick card vs CPU: losses {lc} vs {lp}, max "
          f"abs weight diff {worst:.3e}", flush=True)


# Wrappers that count their tensor-core launches apart (``tc_launches``).
TC_COUNTED = ("conv3x3", "flash_fwd", "flash_dq", "flash_dkv")


def zero_counts(wrappers) -> None:
    for fn in wrappers.values():
        fn.launches = 0
    for name in TC_COUNTED:
        wrappers[name].tc_launches = 0


def read_counts(wrappers) -> dict:
    """Launches of every wrapper, and ``<name>_tc``: those of its
    tensor-core kernel, for conv3x3 and the three flash kernels."""
    counts = {name: fn.launches for name, fn in wrappers.items()}
    for name in TC_COUNTED:
        counts[f"{name}_tc"] = wrappers[name].tc_launches
    return counts


def want_counts(wrappers, **launches) -> dict:
    """The counts a path should read: the given launches, every other
    wrapper 0, and every conv3x3 (the paths run bf16 or f16) and flash
    launch through the tensor cores."""
    want = dict({name: 0 for name in wrappers}, **launches)
    for name in TC_COUNTED:
        want[f"{name}_tc"] = want[name]
    return want


def main_path(torch, wrappers) -> dict:
    """Full-width ResNet-18 through the port's Trainer; counts launches."""
    from ps_pytorch_tpu_torch.config import config_from_args
    from ps_pytorch_tpu_torch.runtime import Trainer

    root = tempfile.mkdtemp(prefix="chip_smoke_main_")
    cfg = config_from_args([
        "--network", "ResNet18", "--dataset", "synthetic_cifar10",
        "--batch-size", str(BATCH), "--test-batch-size", str(BATCH),
        "--max-steps", str(STEPS), "--eval-freq", "0", "--resume", "false",
        "--conv-impl", "pallas", "--fused-optimizer", "--optimizer", "sgd",
        "--momentum", "0.9", "--weight-decay", "5e-4",
        "--compute-dtype", "bfloat16", "--metrics-file", f"{root}/m.jsonl"])
    trainer = Trainer(cfg, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    losses = []
    trainer.metrics.printer = lambda line: (print(line, flush=True),
                                            losses.append(line))
    zero_counts(wrappers)
    trainer.train()
    result = trainer.evaluate(max_batches=EVAL_BATCHES)
    launches = read_counts(wrappers)
    print(f"MAIN step_times_s {trainer.step_times} max_memory_allocated "
          f"{torch.cuda.max_memory_allocated()} eval {result} launches "
          f"{launches}", flush=True)
    rows = read_jsonl(f"{root}/m.jsonl")
    shutil.rmtree(root, ignore_errors=True)
    check_mfu("MAIN", losses, rows, trainer.ops.flops_per_step,
              trainer.ops.peak_per_chip)
    from ps_pytorch_tpu_torch.runtime.metrics import parse_line
    recs = [parse_line(line) for line in losses]
    if len(recs) != STEPS or not all(r and math.isfinite(r["loss"])
                                     for r in recs):
        fail(f"main path: expected {STEPS} STEP lines with finite loss")
    if result["count"] != EVAL_BATCHES * BATCH or not all(
            math.isfinite(result[k]) for k in ("loss", "prec1", "prec5")):
        fail(f"main path: bad evaluation {result}")
    want = want_counts(wrappers, conv3x3=CONV_PER_STEP * STEPS
                       + CONV_PER_EVAL_BATCH * EVAL_BATCHES, fused_sgd=STEPS)
    if launches != want:
        fail(f"main path launches {launches}, expected {want}")
    return dict(launches, median_step_s=float(np.median(trainer.step_times)))


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def telemetry_main_path(torch, wrappers, main_median_s: float) -> dict:
    """MAIN-TELEMETRY: MAIN's ResNet-18 through ``train.run`` with every
    flag of the ops plane, a thread scraping /metrics and /healthz while
    the steps run; every launch count set to 0 just before and read just
    after."""
    from ps_pytorch_tpu_torch import train
    from ps_pytorch_tpu_torch.runtime import checkpoint as ckpt
    from ps_pytorch_tpu_torch.telemetry import parse_exposition

    root = tempfile.mkdtemp(prefix="chip_smoke_telemetry_")
    port = free_port()
    argv = [*TELEMETRY_ARGS, "--train-dir", f"{root}/td", "--metrics-file",
            f"{root}/m.jsonl", "--trace-file", f"{root}/t.json",
            "--profile-dir", f"{root}/prof", "--metrics-port", str(port),
            "--flight-file", f"{root}/f.json"]
    bodies, done = [], threading.Event()

    def scrape():
        # Raw bodies only: parsing waits for the run's end, so the thread
        # holds the interpreter lock as little as a remote scraper would.
        url = f"http://127.0.0.1:{port}"
        while not done.is_set():
            try:
                with urllib.request.urlopen(f"{url}/metrics",
                                            timeout=5) as resp:
                    text = resp.read()
                with urllib.request.urlopen(f"{url}/healthz",
                                            timeout=5) as resp:
                    bodies.append((text, resp.read()))
            except OSError:         # not listening yet, or stopped
                pass
            done.wait(0.05)

    thread = threading.Thread(target=scrape, daemon=True)
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(wrappers)
        thread.start()
        out = io.StringIO()
        with redirect_stdout(out):
            trainer, result = train.run(argv)
        done.set()
        thread.join(timeout=10)
        launches = read_counts(wrappers)
        peak_alloc = torch.cuda.max_memory_allocated()
        for line in out.getvalue().splitlines():
            print(line if len(line) < 400 else line[:200] + " ...",
                  flush=True)
        rows = read_jsonl(f"{root}/m.jsonl")
        trace = json.loads(Path(f"{root}/t.json").read_text())
        profiles = sorted(Path(f"{root}/prof").glob("*.json"))
        kernels = [] if len(profiles) != 1 else [
            e["name"] for e in json.loads(profiles[0].read_text())[
                "traceEvents"] if e.get("cat") == "kernel"]
        committed = ckpt.committed_steps(f"{root}/td")
    finally:
        done.set()
        shutil.rmtree(root, ignore_errors=True)
    scrapes = [(parse_exposition(text.decode()), json.loads(health))
               for text, health in bodies]
    lines = out.getvalue().splitlines()
    check_mfu("MAIN-TELEMETRY", lines, rows, trainer.ops.flops_per_step,
              trainer.ops.peak_per_chip)
    if [r["step"] for r in rows] != list(range(1, TELEMETRY_STEPS + 1)) \
            or committed != [TELEMETRY_STEPS]:
        fail(f"MAIN-TELEMETRY: JSONL steps {[r['step'] for r in rows]}, "
             f"checkpoints {committed}")
    mem = [r.get("device_mem_peak_bytes") for r in rows]
    if not all(m and m > 0 for m in mem) or mem != sorted(mem) or \
            max(mem) > peak_alloc:
        fail(f"MAIN-TELEMETRY: device_mem_peak_bytes {mem} is not positive "
             f"and rising or holding up to max_memory_allocated "
             f"{peak_alloc}")
    seen = [m["train_steps_total"] for m, _ in scrapes]
    if len({v for v in seen if 1 <= v <= TELEMETRY_STEPS}) < 2 or \
            seen != sorted(seen) or not all(
                m["health_ok"] == 1 and h["ok"] for m, h in scrapes) or \
            not any(m["device_mem_peak_bytes"] > 0 for m, _ in scrapes):
        fail(f"MAIN-TELEMETRY: scrapes saw train_steps_total {seen}, "
             "expected it rising with health_ok 1 and device memory")
    spans = {e["name"] for e in trace["traceEvents"] if e["ph"] == "X"}
    if not set(TELEMETRY_SPANS) <= spans:
        fail(f"MAIN-TELEMETRY: trace spans {sorted(spans)} lack "
             f"{sorted(set(TELEMETRY_SPANS) - spans)}")
    tc = [k for k in kernels if "conv3x3_tc" in k]
    if not tc:
        fail(f"MAIN-TELEMETRY: the profile ({len(profiles)} files, "
             f"{len(kernels)} kernel events) holds no conv3x3_tc kernel")
    want = want_counts(wrappers, fused_sgd=TELEMETRY_STEPS,
                       conv3x3=CONV_PER_STEP * TELEMETRY_STEPS
                       + CONV_PER_EVAL_BATCH * 2)
    if launches != want:
        fail(f"MAIN-TELEMETRY launches {launches}, expected {want}")
    median = float(np.median(trainer.step_times))
    # Outside the first step and the profiled window (steps 3-4).
    steady = float(np.median([t for k, t in enumerate(trainer.step_times, 1)
                              if k not in (1, 3, 4)]))
    print(f"MAIN-TELEMETRY scrapes {len(scrapes)} train_steps_total seen "
          f"{sorted(set(seen))} health_ok 1 device_mem_peak_bytes "
          f"{mem[-1]} (JSONL, rising or holding; max_memory_allocated "
          f"{peak_alloc}) spans {sorted(spans)} profile kernel events "
          f"{len(kernels)} conv3x3_tc {len(tc)} ({tc[0]}) launches "
          f"{launches}", flush=True)
    print(f"MAIN-TELEMETRY step_times_s {trainer.step_times} median "
          f"{median:.4f} s against MAIN's {main_median_s:.4f} s (ratio "
          f"{median / main_median_s:.3f}; profiled steps 3-4, scraped "
          f"every 50 ms); steps 2, 5-8 {steady:.4f} s (ratio "
          f"{steady / main_median_s:.3f}) eval {result}", flush=True)
    return launches


def nan_mask_at(trainer, bad_step: int) -> None:
    """The JAX package's grad_nan fault, by hand: the coordinator's mask
    is NaN at ``bad_step`` (loss, gradients and grad norm go NaN)."""
    decide = trainer.coordinator.participation_mask

    def mask(step, *args, **kw):
        m = np.asarray(decide(step, *args, **kw), np.float32)
        return m * np.nan if step == bad_step else m
    trainer.coordinator.participation_mask = mask


def health_on_card(torch) -> None:
    """HEALTH: full-width ResNet-18 Trainers on the card with a NaN mask at
    step 3. ``nonfinite:halt`` stops there with model_step_3 and a flight
    dump; ``nonfinite:skip`` leaves the parameters of step 2 bitwise and
    trains steps 4-5."""
    from ps_pytorch_tpu_torch.config import config_from_args
    from ps_pytorch_tpu_torch.runtime import Trainer
    from ps_pytorch_tpu_torch.runtime import checkpoint as ckpt
    from ps_pytorch_tpu_torch.telemetry import load_flight

    base = ["--network", "ResNet18", "--dataset", "synthetic_cifar10",
            "--batch-size", str(BATCH), "--compute-dtype", "bfloat16",
            "--conv-impl", "pallas", "--fused-optimizer", "--momentum",
            "0.9", "--eval-freq", "0", "--resume", "false"]
    root = tempfile.mkdtemp(prefix="chip_smoke_health_")
    try:
        lines = []
        halt = Trainer(config_from_args(
            [*base, "--max-steps", "6", "--health-spec", "nonfinite:halt",
             "--train-dir", f"{root}/halt", "--flight-file",
             f"{root}/f.json"]), device="cuda", printer=lines.append)
        nan_mask_at(halt, 3)
        halt.train()
        for line in lines:
            print(line, flush=True)
        reason = load_flight(f"{root}/f.json")["reason"]
        saved = ckpt.committed_steps(f"{root}/halt")
        if not any(ln.startswith("HEALTH halt at step 3") for ln in lines) \
                or saved != [3] or reason != "watchdog:nonfinite":
            fail(f"HEALTH halt: checkpoints {saved}, flight {reason}")
        skip = Trainer(config_from_args(
            [*base, "--max-steps", "5", "--health-spec", "nonfinite:skip",
             "--train-dir", f"{root}/skip"]), device="cuda",
            printer=lambda line: None)
        nan_mask_at(skip, 3)
        params, step = [], skip.step_fn

        def spy(*args, **kw):
            out = step(*args, **kw)
            params.append(torch.cat([p.detach().reshape(-1).clone() for p
                                     in skip.model.parameters()]))
            return out
        spy.comm_s = 0.0
        skip.step_fn = spy
        skip.train()
        skip.step_fn = step     # no trainer <-> spy cycle outlives the phase
        kept = torch.equal(params[1], params[2])
        moved = [not torch.equal(a, b) for a, b in zip(params[2:],
                                                         params[3:])]
        finite = bool(torch.isfinite(params[-1]).all())
        print(f"HEALTH halt at step 3: checkpoints {saved}, flight reason "
              f"{reason}; skip: parameters after step 3 equal step 2's "
              f"bitwise {kept}, steps 4-5 moved {moved}, finite {finite}, "
              f"nonfinite trips {skip.ops.health.trips['nonfinite']}",
              flush=True)
        if not kept or not all(moved) or not finite:
            fail("HEALTH skip: the NaN step changed the parameters or the "
                 "next steps did not train")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def check_mfu(phase: str, lines, rows, flops, peak) -> None:
    """The path's FLOPs a step equal the JAX package's xla / full count,
    the peak is the H100's, every STEP line prints a numeric mfu, and every
    JSONL row's mfu is that count over its step time and the peak (to
    1e-6: the JSONL rounds to 6 places)."""
    from ps_pytorch_tpu_torch.runtime.metrics import parse_line

    if flops != FLOPS_A_STEP[phase]:
        fail(f"{phase}: {flops} FLOPs a step, expected {FLOPS_A_STEP[phase]}")
    if peak != MFU_PEAK:
        fail(f"{phase}: peak {peak} FLOP/s for this card, expected "
             f"{MFU_PEAK}: the card's name is not in the peak table")
    recs = [parse_line(line) for line in lines if line.startswith("STEP")]
    if not recs or any(r is None or r.get("mfu") is None for r in recs):
        fail(f"{phase}: a STEP line without a numeric mfu")
    for row in rows:
        want = flops / (row["step_time"] * peak)
        if row["mfu"] is None or abs(row["mfu"] - want) > 1e-6:
            fail(f"{phase}: JSONL mfu {row['mfu']} at step {row['step']}, "
                 f"expected {want}")
    print(f"{phase} flops_per_step {flops} peak_flops_per_s {peak:.6g} "
          f"mfu {[r['mfu'] for r in recs]} (JSONL {len(rows)} rows, each "
          f"within 1e-6 of count / (step_time * peak))", flush=True)


def f16_main_path(torch, wrappers, main_median_s: float) -> dict:
    """MAIN-F16: ResNet-18 in float16 with ``--conv-impl pallas`` through
    ``train.main`` (4 steps, checkpoints at 2 and 4), ``evaluate.main
    --once 4``, ``train.main`` resumed from a copy of step 2 to step 4, and
    one step with ``--conv-impl xla``. Every launch count is set to 0 just
    before each run and read just after: 26 f16 conv3x3 launches a step
    and 13 an eval batch, all through the tensor-core kernel, a fused SGD
    a step, none in the xla run's convs. The losses are finite, the
    step-1 loss within rtol 1e-2 of the xla run's (cuDNN in f16, the same
    weights and batch), the EVAL line finite, and the resumed steps and
    step-4 checkpoint equal the uninterrupted run's bit for bit."""
    from ps_pytorch_tpu_torch import evaluate, train
    from ps_pytorch_tpu_torch.runtime import checkpoint as ckpt

    root = tempfile.mkdtemp(prefix="chip_smoke_f16_")
    td, td2 = f"{root}/td", f"{root}/resumed"
    pallas = (*F16_ARGS, "--conv-impl", "pallas", "--resume", "false")
    step_re = re.compile(r"^STEP (\d+) .*? loss (\S+)", re.M)
    counts = {}
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(wrappers)
        t0 = time.monotonic()
        out = run_entry(train.main, [
            *pallas, "--max-steps", str(F16_STEPS), "--eval-freq", "2",
            "--train-dir", td, "--metrics-file", f"{root}/m.jsonl"])
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        peak = torch.cuda.max_memory_allocated()
        counts["run"] = read_counts(wrappers)
        whole = step_re.findall(out)
        rows = read_jsonl(f"{root}/m.jsonl")
        zero_counts(wrappers)
        found = EVAL_RE.findall(run_entry(
            evaluate.main, ["--train-dir", td, "--once", str(F16_STEPS)]))
        counts["evaluate"] = read_counts(wrappers)
        shutil.copytree(ckpt.checkpoint_path(td, 2),
                        ckpt.checkpoint_path(td2, 2))
        zero_counts(wrappers)
        resumed_out = run_entry(train.main, [
            *F16_ARGS, "--conv-impl", "pallas", "--max-steps",
            str(F16_STEPS), "--eval-freq", "2", "--train-dir", td2])
        counts["resumed"] = read_counts(wrappers)
        resumed = step_re.findall(resumed_out)
        same_bytes = all(
            Path(ckpt.checkpoint_path(td, F16_STEPS), name).read_bytes()
            == Path(ckpt.checkpoint_path(td2, F16_STEPS), name).read_bytes()
            for name in ("state.msgpack", "meta.json"))
        zero_counts(wrappers)
        xla = step_re.findall(run_entry(train.main, [
            *F16_ARGS, "--conv-impl", "xla", "--resume", "false",
            "--max-steps", "1", "--eval-freq", "0", "--train-dir",
            f"{root}/xla"]))
        counts["xla"] = read_counts(wrappers)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if [int(k) for k, _ in whole] != list(range(1, F16_STEPS + 1)) or \
            not all(math.isfinite(float(v)) for _, v in whole):
        fail(f"MAIN-F16: STEP lines {whole}, expected {F16_STEPS} finite")
    if len(found) != 1 or found[0][0] != str(F16_STEPS) or not all(
            math.isfinite(float(v)) for v in found[0][1:]):
        fail(f"MAIN-F16: evaluate.main printed no finite EVAL step "
             f"{F16_STEPS}")
    if f"RESUME from {ckpt.checkpoint_path(td2, 2)} at step 2" \
            not in resumed_out or resumed != whole[2:] or not same_bytes:
        fail(f"MAIN-F16: the run resumed at step 2 printed {resumed} "
             f"against {whole[2:]}, checkpoint bytes equal {same_bytes}")
    loss1, loss1_xla = float(whole[0][1]), float(xla[0][1])
    if not np.isclose(loss1, loss1_xla, rtol=1e-2, atol=0.0):
        fail(f"MAIN-F16: step-1 loss {loss1} on the conv3x3 kernel, "
             f"{loss1_xla} on cuDNN (rtol 1e-2)")
    eval_launches = CONV_PER_EVAL_BATCH * F16_EVAL_BATCHES
    wants = {
        "run": want_counts(wrappers, fused_sgd=F16_STEPS,
                           conv3x3=CONV_PER_STEP * F16_STEPS
                           + eval_launches),
        "evaluate": want_counts(wrappers, conv3x3=eval_launches),
        "resumed": want_counts(wrappers, fused_sgd=F16_STEPS - 2,
                               conv3x3=CONV_PER_STEP * (F16_STEPS - 2)
                               + eval_launches),
        "xla": want_counts(wrappers, fused_sgd=1)}
    for run, want in wants.items():
        if counts[run] != want:
            fail(f"MAIN-F16 {run} launches {counts[run]}, expected {want}")
    times = [r["step_time"] for r in rows]
    median = float(np.median(times[1:]))
    print(f"MAIN-F16 step_times_s {times} images_per_s "
          f"{[r['examples_per_sec'] for r in rows]} median_step_s "
          f"{median:.5f} ({BATCH / median:.1f} images/s; bf16 MAIN "
          f"{main_median_s:.5f} s, ratio {median / main_median_s:.3f}) "
          f"train_main_s {wall:.2f} max_memory_allocated {peak} step1_loss "
          f"{loss1} xla {loss1_xla} eval {found[0]} launches {counts}",
          flush=True)
    total = {name: sum(c[name] for c in counts.values())
             for name in counts["run"]}
    return dict(total, median_step_s=median, by_run=counts)


def lm_main_path(torch, wrappers) -> dict:
    """Full-width TransformerLM through the port's LMTrainer (flash
    attention, f32, plain SGD with momentum); counts launches."""
    from ps_pytorch_tpu_torch.config import config_from_args
    from ps_pytorch_tpu_torch.runtime.lm_trainer import LMTrainer
    from ps_pytorch_tpu_torch.runtime.metrics import parse_line

    root = tempfile.mkdtemp(prefix="chip_smoke_lm_")
    cfg = config_from_args([*LM_ARGS, "--max-steps", str(STEPS),
                            "--eval-freq", "0", "--resume", "false",
                            "--metrics-file", f"{root}/m.jsonl"])
    trainer = LMTrainer(cfg, device="cuda")
    lines = []
    trainer.metrics.printer = lambda line: (print(line, flush=True),
                                            lines.append(line))
    torch.cuda.reset_peak_memory_stats()
    zero_counts(wrappers)
    trainer.train()
    result = trainer.evaluate(max_batches=EVAL_BATCHES)
    launches = read_counts(wrappers)
    tokens = LM_BATCH * LM_SEQ
    print(f"MAIN-LM step_times_s {trainer.step_times} tokens_per_s "
          f"{[round(tokens / t, 1) for t in trainer.step_times]} "
          f"max_memory_allocated {torch.cuda.max_memory_allocated()} eval "
          f"{result} launches {launches}", flush=True)
    rows = read_jsonl(f"{root}/m.jsonl")
    shutil.rmtree(root, ignore_errors=True)
    check_mfu("MAIN-LM", lines, rows, trainer.ops.flops_per_step,
              trainer.ops.peak_per_chip)
    recs = [parse_line(line) for line in lines]
    if len(recs) != STEPS or not all(r and math.isfinite(r["loss"])
                                     for r in recs):
        fail(f"LM main path: expected {STEPS} STEP lines with finite loss")
    if not recs[-1]["loss"] < recs[0]["loss"]:
        fail(f"LM main path: loss did not fall ({recs[0]['loss']} -> "
             f"{recs[-1]['loss']})")
    if result["batches"] != EVAL_BATCHES or not all(
            math.isfinite(result[k]) for k in ("loss", "perplexity")):
        fail(f"LM main path: bad evaluation {result}")
    per_pass = LM_LAYERS               # one attention call a layer
    want = want_counts(wrappers, flash_fwd=per_pass * (STEPS + EVAL_BATCHES),
                       flash_dq=per_pass * STEPS, flash_dkv=per_pass * STEPS)
    if launches != want:
        fail(f"LM main path launches {launches}, expected {want}")
    return launches


def lm8k_main_path(torch, F, fa, wrappers) -> dict:
    """MAIN-LM8K (``LM8K_ARGS``): the three flash kernels at [1, 8, 8192,
    64] f32 against their plain versions and SDPA; ``train_lm.run`` for 3
    steps with a checkpoint at 3; ``evaluate.main --once 3`` through the
    flash oracle; the same checkpoint through the full-attention oracle
    (the evaluator with ``scoring_attention`` set to full). Fails unless
    both oracles' EVAL_LM agree at 1e-4 and the full oracle's mean over
    FINAL's batches is FINAL's loss at 1e-4, the flash kernels launched
    as the run says (all ``tc``: 8 forwards a step and an eval batch, 8
    dq and dk/dv a step) and the full oracle none. Prints the median step,
    tokens a second and the peak device memory of training and of each
    oracle."""
    from ps_pytorch_tpu_torch import evaluate, train_lm
    from ps_pytorch_tpu_torch.config import config_from_args
    from ps_pytorch_tpu_torch.data.text import TokenLoader, lm_streams
    from ps_pytorch_tpu_torch.runtime import evaluator as ev_mod
    from ps_pytorch_tpu_torch.tools.profile_capture import card_line

    card = card_line()
    figures = check_flash(torch, F, fa, LM8K_FLASH_CASES, LM8K_FLASH_SHAPE)
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="chip_smoke_lm8k_")
    td = f"{root}/td"
    try:
        cfg = config_from_args([*LM8K_ARGS, "--train-dir", td])
        seq = cfg.lm_seq_len
        val_batches = sum(1 for _ in TokenLoader(
            lm_streams(cfg)[1], cfg.batch_size, seq, seed=0,
            shuffle=False).epoch(0))
        final_batches = min(LM8K_FINAL_BATCHES, val_batches)
        torch.cuda.reset_peak_memory_stats()
        zero_counts(wrappers)
        out = io.StringIO()
        with redirect_stdout(out):
            trainer, result = train_lm.run([
                *LM8K_ARGS, "--max-steps", str(LM8K_STEPS), "--eval-freq",
                str(LM8K_STEPS), "--resume", "false", "--train-dir", td,
                "--device", "cuda"])
        torch.cuda.synchronize()
        train_peak = torch.cuda.max_memory_allocated()
        runs = {"train": read_counts(wrappers)}
        steps = trainer.step_times
        del trainer
        for line in out.getvalue().splitlines():
            if line.startswith(("STEP", "FINAL", "LM mesh")):
                print(line, flush=True)
        peaks, lines, batch_losses = {}, {}, []
        for oracle in ("flash", "full"):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            zero_counts(wrappers)
            chosen = ev_mod.scoring_attention
            if oracle == "full":
                ev_mod.scoring_attention = lambda cfg: "full"
                build_lm = ev_mod.Evaluator._build_lm

                def recorded(self, cfg):
                    build_lm(self, cfg)
                    inner = self._lm_loss

                    def each(tokens):
                        batch_losses.append(inner(tokens))
                        return batch_losses[-1]

                    self._lm_loss = each

                ev_mod.Evaluator._build_lm = recorded
            try:
                printed = run_entry(evaluate.main, [
                    "--train-dir", td, "--once", str(LM8K_STEPS),
                    "--device", "cuda"])
            finally:
                ev_mod.scoring_attention = chosen
                if oracle == "full":
                    ev_mod.Evaluator._build_lm = build_lm
            torch.cuda.synchronize()
            peaks[oracle] = torch.cuda.max_memory_allocated()
            runs[oracle] = read_counts(wrappers)
            found = EVAL_LM_RE.findall(printed)
            if len(found) != 1 or found[0][0] != str(LM8K_STEPS):
                fail(f"MAIN-LM8K: the {oracle} oracle printed {found}")
            lines[oracle] = found[0]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    final = result["loss"]
    flash_loss, full_loss = (float(lines[k][1]) for k in ("flash", "full"))
    head = float(np.mean(batch_losses[:final_batches]))
    if len(batch_losses) != val_batches or abs(flash_loss - full_loss) > \
            1e-4 or abs(head - final) > 1e-4 or not math.isfinite(final):
        fail(f"MAIN-LM8K: EVAL_LM flash {flash_loss} / full {full_loss} "
             f"over {len(batch_losses)} batches, FINAL {final} against the "
             f"full oracle's first {final_batches} batches {head}")
    want = {"train": lm_flash_counts(wrappers, LM8K_STEPS, final_batches,
                                     LM_LAYERS, remat=False),
            "flash": want_counts(wrappers,
                                 flash_fwd=LM_LAYERS * val_batches),
            "full": want_counts(wrappers)}
    for name, counts in runs.items():
        if counts != want[name]:
            fail(f"MAIN-LM8K {name} launches {counts}, expected "
                 f"{want[name]}")
    median = float(np.median(steps[1:]))
    print(f"MAIN-LM8K S {seq} batch 1 f32 flash: step_times_s {steps} "
          f"median (steps 2 on) {median:.4f} s tokens_per_s "
          f"{seq / median:.1f} train peak {train_peak} B; FINAL "
          f"{final:.6f} over {final_batches} batches; EVAL_LM flash "
          f"{lines['flash']} peak {peaks['flash']} B, full {lines['full']} "
          f"peak {peaks['full']} B over {val_batches} batches (|flash - "
          f"full| {abs(flash_loss - full_loss):.3e}; full over FINAL's "
          f"batches {head:.6f}, |diff| {abs(head - final):.3e}); launches "
          f"train {flash_by_kind(runs['train'])} flash oracle "
          f"{flash_by_kind(runs['flash'])} full oracle "
          f"{flash_by_kind(runs['full'])}; card {card}", flush=True)
    return dict(figures=figures, launches=runs["train"],
                oracle_launches=runs["flash"])


def run_entry(main, argv) -> str:
    """Run an entry point's ``main``; echo and return what it printed."""
    out = io.StringIO()
    with redirect_stdout(out):
        rc = main(argv)
    for line in out.getvalue().splitlines():    # the CONFIG line is 3 KB
        print(line if len(line) < 400 else line[:200] + " ...", flush=True)
    if rc != 0:
        fail(f"{main.__module__} exited {rc}")
    return out.getvalue()


def ckpt_main_path(torch, wrappers) -> dict:
    """ResNet-18 with fused Adam through ``train.main`` (checkpoints at
    steps 3 and 6), a resumed Trainer to step 8 against an uninterrupted
    8-step one, and ``evaluate.main --once 6``; counts launches."""
    from ps_pytorch_tpu_torch import evaluate, train
    from ps_pytorch_tpu_torch.config import config_from_args
    from ps_pytorch_tpu_torch.data import load_arrays
    from ps_pytorch_tpu_torch.models.convert import state_to_jax
    from ps_pytorch_tpu_torch.runtime import Trainer
    from ps_pytorch_tpu_torch.runtime import checkpoint as ckpt

    eval_batches = math.ceil(len(load_arrays("synthetic_cifar10",
                                             train=False)[1]) / 1000)
    # The trainers set deterministic cuDNN algorithms themselves (the stem
    # and the strided convs), so that the resumed run can equal the
    # uninterrupted one.
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    td, whole_dir = f"{root}/td", f"{root}/whole"
    try:
        zero_counts(wrappers)
        t0 = time.monotonic()
        out = run_entry(train.main, [*CKPT_ARGS, "--max-steps", "6",
                                     "--eval-freq", "3", "--train-dir", td,
                                     "--device", "cuda"])
        t_train = time.monotonic() - t0
        if [int(x) for x in re.findall(r"^STEP (\d+) ", out, re.M)] != \
                list(range(1, 7)):
            fail("MAIN-CKPT: train.main did not print STEP 1..6")
        if ckpt.committed_steps(td) != [3, 6] or not all(
                ckpt.verify_checkpoint(td, k) for k in (3, 6)):
            fail(f"MAIN-CKPT: checkpoints {ckpt.committed_steps(td)}, "
                 "expected model_step_3 and model_step_6, verified")
        nbytes = sum(f.stat().st_size
                     for f in Path(ckpt.checkpoint_path(td, 6)).iterdir())
        cfg = config_from_args([*CKPT_ARGS, "--max-steps", "8",
                                "--eval-freq", "3", "--train-dir", td])
        out = io.StringIO()
        with redirect_stdout(out):
            resumed = Trainer(cfg, device="cuda")
        print(out.getvalue(), end="", flush=True)
        if f"RESUME from {ckpt.checkpoint_path(td, 6)} at step 6" \
                not in out.getvalue() or resumed.start_step != 6:
            fail("MAIN-CKPT: the second Trainer did not resume at step 6")
        lines = []
        resumed.metrics.printer = lambda line: (print(line, flush=True),
                                                lines.append(line))
        resumed.train()
        if [int(ln.split()[1]) for ln in lines] != [7, 8]:
            fail(f"MAIN-CKPT: the resumed run printed {lines}")
        whole = Trainer(config_from_args(
            [*CKPT_ARGS, "--max-steps", "8", "--eval-freq", "0",
             "--resume", "false", "--train-dir", whole_dir]), device="cuda",
            printer=lambda line: None)
        whole.train()
        got = state_to_jax(resumed.model, resumed.step_fn.opt_state, 8)
        want = state_to_jax(whole.model, whole.step_fn.opt_state, 8)
        diff, close = 0.0, True
        for part in ("params", "opt_state"):
            for a, b in zip(flat_leaves(got[part]), flat_leaves(want[part])):
                diff = max(diff, float(np.abs(a - b).max()))
                close &= bool(np.allclose(a, b, rtol=1e-6, atol=0.0))
        print(f"CHECK resume: params and Adam moments after step 8, resumed "
              f"at 6 vs uninterrupted: max abs diff {diff:.3e}", flush=True)
        if not close:
            fail(f"MAIN-CKPT: the resumed run differs by {diff} (rtol 1e-6)")
        out = run_entry(evaluate.main, ["--train-dir", td, "--once", "6"])
        found = EVAL_RE.findall(out)
        if len(found) != 1 or found[0][0] != "6" or not all(
                math.isfinite(float(x)) for x in found[0][1:]):
            fail("MAIN-CKPT: evaluate.main printed no finite EVAL step 6")
        launches = read_counts(wrappers)
        t0 = time.monotonic()
        resumed.checkpoint(8)
        t_save = time.monotonic() - t0
        t0 = time.monotonic()
        ckpt.load_checkpoint(td, 8, resumed._restore)
        torch.cuda.synchronize()
        t_load = time.monotonic() - t0
        print(f"MAIN-CKPT train_main_s {t_train:.2f} step_times_s "
              f"{resumed.step_times + whole.step_times} checkpoint_bytes "
              f"{nbytes} save_s {t_save:.3f} load_s {t_load:.3f} launches "
              f"{launches}", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    steps = 6 + 2 + 8
    want = want_counts(wrappers, fused_adam=steps,
                       conv3x3=CONV_PER_STEP * steps
                       + CONV_PER_EVAL_BATCH * 2 * eval_batches)
    if launches != want:
        fail(f"MAIN-CKPT launches {launches}, expected {want}")
    return launches


def eval_batch_count(dataset: str, test_batch: int) -> int:
    """Eval batches of a synthetic set's test split (about a sixth of
    train, at least 1000, at most train), without making it."""
    from ps_pytorch_tpu_torch.data import DATASET_SHAPES
    n = DATASET_SHAPES[dataset][4]
    return math.ceil(max(n // 6, min(1000, n)) / test_batch)


def entry_path(torch, wrappers, phase: str, args, steps: int,
               eval_batches: int, conv_per_step: int,
               conv_per_eval_batch: int) -> dict:
    """``train.main`` for ``steps`` steps with a checkpoint at the last,
    then ``evaluate.main --once`` on it, every launch count set to 0 just
    before and read just after: STEP lines with finite losses, a finite
    FINAL and EVAL, conv3x3 launches all through the tensor cores, one
    fused SGD a step. ``eval_batches`` is that of one evaluation (the
    trainer's final one and the evaluator's are counted)."""
    from ps_pytorch_tpu_torch import evaluate, train
    from ps_pytorch_tpu_torch.config import config_from_args
    from ps_pytorch_tpu_torch.utils.flops import (
        peak_flops_bf16, training_flops,
    )

    root = tempfile.mkdtemp(prefix="chip_smoke_entry_")
    td = f"{root}/td"
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(wrappers)
        t0 = time.monotonic()
        out = run_entry(train.main, [
            *args, "--max-steps", str(steps), "--eval-freq", str(steps),
            "--train-dir", td, "--metrics-file", f"{root}/m.jsonl"])
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        peak = torch.cuda.max_memory_allocated()
        found = EVAL_RE.findall(run_entry(
            evaluate.main, ["--train-dir", td, "--once", str(steps)]))
        launches = read_counts(wrappers)
        rows = read_jsonl(f"{root}/m.jsonl")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    final = re.search(r"^FINAL loss (\S+) prec1 (\S+) prec5 (\S+)$", out,
                      re.M)
    if [r["step"] for r in rows] != list(range(1, steps + 1)) or not all(
            math.isfinite(r["loss"]) for r in rows):
        fail(f"{phase}: expected {steps} steps with finite loss")
    if not final or not all(math.isfinite(float(v)) for v in final.groups()):
        fail(f"{phase}: no finite FINAL line")
    if len(found) != 1 or found[0][0] != str(steps) or not all(
            math.isfinite(float(v)) for v in found[0][1:]):
        fail(f"{phase}: evaluate.main printed no finite EVAL step {steps}")
    print(f"{phase} step_times_s {[r['step_time'] for r in rows]} "
          f"images_per_s {[r['examples_per_sec'] for r in rows]} "
          f"train_main_s {wall:.2f} max_memory_allocated {peak} "
          f"launches {launches}", flush=True)
    i = args.index("--device")          # the entry point's, not a field
    check_mfu(phase, out.splitlines(), rows,
              training_flops(config_from_args([*args[:i], *args[i + 2:]])),
              peak_flops_bf16(torch.cuda.get_device_name(0)))
    want = want_counts(wrappers, fused_sgd=steps,
                       conv3x3=conv_per_step * steps
                       + conv_per_eval_batch * 2 * eval_batches)
    if launches != want:
        fail(f"{phase} launches {launches}, expected {want}")
    return dict(launches, peak=peak)


def vgg_main_path(torch, wrappers) -> dict:
    """MAIN-VGG: VGG11 (BatchNorm, biased convs, Dropout) on synthetic
    CIFAR-100 through the entry points: 7 conv3x3 launches a forward (every
    conv past the 3-channel input conv), 14 a train step."""
    per_pass = sum(n for _, _, _, n in VGG_GEOMETRIES)
    return entry_path(torch, wrappers, "MAIN-VGG", VGG_ARGS, VGG_STEPS,
                      eval_batch_count("synthetic_cifar100", 4167),
                      2 * per_pass, per_pass)


def imagenet_main_path(torch, wrappers) -> dict:
    """MAIN-IMAGENET: ResNet-50 at 224 px on synthetic_imagenet_rrc
    through the entry points, the RRC loader running its native kernel: 13
    conv3x3 launches a forward, 26 a train step."""
    from ps_pytorch_tpu_torch.data import augment

    backend = augment.rrc_backend()
    print(f"MAIN-IMAGENET rrc_backend {backend}", flush=True)
    if backend != "native":
        fail("MAIN-IMAGENET: the RRC loader runs its numpy version, not "
             "the native kernel")
    per_pass = sum(n for _, _, _, n in RESNET50_GEOMETRIES)
    return entry_path(torch, wrappers, "MAIN-IMAGENET", IMAGENET_ARGS,
                      IMAGENET_STEPS,
                      eval_batch_count("synthetic_imagenet_rrc", 1000),
                      2 * per_pass, per_pass)


def small_bf16_step_agrees(torch, conv_mod, label: str, build, hw: int,
                           masks=()) -> None:
    """One bf16 train step of a small model from ``build(device)`` (conv
    pallas, fused SGD, uint8 batches normalized in the step), on the card
    and on the CPU from the same weights and batch, each Dropout layer fed
    the same mask: losses agree at rtol 1e-2, as the small bf16 ResNet
    step; every conv3x3 launch on the tensor cores."""
    from ps_pytorch_tpu_torch.ops.fused_sgd import FusedSGD
    from ps_pytorch_tpu_torch.parallel import make_train_step

    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (8, hw, hw, 3), dtype=np.uint8)
    y = rng.integers(0, 10, 8).astype(np.int32)
    norm = (np.full(3, 1 / 64.0, np.float32), np.full(3, 2.0, np.float32))
    runs = {}
    before = (conv_mod.conv3x3.launches, conv_mod.conv3x3.tc_launches)
    for dev in ("cuda", "cpu"):
        model = build(dev)
        for k, keep in enumerate(masks):
            getattr(model, f"Dropout_{k}").mask_fn = (
                lambda t, keep=keep: torch.from_numpy(keep))
        step = make_train_step(model, FusedSGD(0.05, momentum=0.9,
                                               weight_decay=5e-4),
                               input_norm=norm)
        loss = float(step(x, y, np.ones(1, np.float32), key=1)["loss"])
        runs[dev] = (loss, {k: v.detach().cpu() for k, v
                            in model.state_dict().items()})
    launches = conv_mod.conv3x3.launches - before[0]
    tc = conv_mod.conv3x3.tc_launches - before[1]
    (lc, sc), (lp, sp) = runs["cuda"], runs["cpu"]
    worst = max((sc[k].float() - sp[k].float()).abs().max().item()
                for k in sc)
    if launches == 0 or tc != launches:
        fail(f"small {label} step: {launches} conv3x3 launches, {tc} "
             "through the tensor cores")
    if not (math.isfinite(lc) and np.isclose(lc, lp, rtol=1e-2, atol=0.0)):
        fail(f"small {label} step bf16: loss on the card {lc} vs CPU {lp}")
    print(f"CHECK small {label} step bfloat16 card vs CPU: loss {lc} vs "
          f"{lp}, max abs weight diff {worst:.3e}, conv3x3 launches "
          f"{launches} (tensor cores {tc})", flush=True)


def small_vgg_and_stem_steps_agree(torch, conv_mod) -> None:
    """A narrow VGG (BatchNorm, biased convs, both Dropout layers with
    injected masks) at 32 px, and a ResNet with the ImageNet stem (7x7/2
    conv, 3x3/2 max pool, global mean; two Bottlenecks a stage) at 64 px."""
    from ps_pytorch_tpu_torch.models.resnet import Bottleneck, ResNet
    from ps_pytorch_tpu_torch.models.vgg import VGG

    rng = np.random.default_rng(1)
    small_bf16_step_agrees(
        torch, conv_mod, "VGG",
        lambda dev: VGG((16, "M", 32, "M", 32, "M", 64, "M", 64, "M"), True,
                        10, torch.bfloat16, "pallas",
                        torch.Generator().manual_seed(3)).to(dev),
        32, masks=(rng.random((8, 64)) < 0.5, rng.random((8, 512)) < 0.5))
    small_bf16_step_agrees(
        torch, conv_mod, "ImageNet-stem ResNet",
        lambda dev: ResNet(Bottleneck, (2, 2, 2, 2), 10, torch.bfloat16,
                           "pallas", torch.Generator().manual_seed(3),
                           imagenet_stem=True).to(dev), 64)


def flat_leaves(tree):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat_leaves(v)
        else:
            yield np.asarray(v, np.float64)


def digits_accuracy(torch) -> None:
    """LeNet on the UCI digits through the port's ``tools/accuracy_run``
    on the card (``train`` and then ``evaluate --once``, each a process):
    Prec@1 at least 0.98, read from the tool's artifact."""
    from ps_pytorch_tpu_torch.tools import accuracy_run

    root = tempfile.mkdtemp(prefix="chip_smoke_digits_")
    try:
        accuracy_run.run(["--train-dir", f"{root}/td", "--out",
                          f"{root}/accuracy.json", "--device", "cuda"])
        art = json.loads(Path(root, "accuracy.json").read_text())
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if not (art["steps"] == 1200 and art["prec1"] >= 0.98
            and art["met_target"] and art["platform"] == "gpu"):
        fail(f"ACCURACY digits: {art}, Prec@1 below 0.98")
    print(f"ACCURACY digits LeNet {art['steps']} steps: prec1 "
          f"{art['prec1']:.4f} prec5 {art['prec5']:.4f} loss "
          f"{art['eval_loss']} train_wall_s {art['train_wall_s']} (a "
          f"process, its start included) on {art['device_kind']}",
          flush=True)


def small_step_agrees(torch, conv_mod, dtype_name: str) -> None:
    """One small ResNet (one BasicBlock a stage, conv pallas, fused SGD), 2
    train steps on the card and on the CPU from the same weights and
    batches. f32 runs the SIMT kernel only; losses and weights agree at
    rtol 1e-3, atol 1e-4 (sums run in another order on the card). bf16 and
    f16 run every conv3x3 launch through the tensor cores; losses agree at
    rtol 1e-2 (16-bit activations round at other places in another
    order)."""
    from ps_pytorch_tpu_torch.models.resnet import BasicBlock, ResNet
    from ps_pytorch_tpu_torch.ops.fused_sgd import FusedSGD
    from ps_pytorch_tpu_torch.parallel import make_train_step

    rng = np.random.default_rng(0)
    batches = [(rng.integers(0, 256, (8, 32, 32, 3), dtype=np.uint8),
                rng.integers(0, 10, 8).astype(np.int32)) for _ in range(2)]
    norm = (np.full(3, 1 / 64.0, np.float32), np.full(3, 2.0, np.float32))
    runs = {}
    before = (conv_mod.conv3x3.launches, conv_mod.conv3x3.tc_launches)
    for dev in ("cuda", "cpu"):
        model = ResNet(BasicBlock, (1, 1, 1, 1), 10,
                       getattr(torch, dtype_name), "pallas",
                       torch.Generator().manual_seed(3)).to(dev)
        step = make_train_step(model, FusedSGD(0.05, momentum=0.9,
                                               weight_decay=5e-4),
                               input_norm=norm)
        losses = [float(step(x, y, np.ones(1, np.float32))["loss"])
                  for x, y in batches]
        runs[dev] = (losses, {k: v.detach().cpu() for k, v
                              in model.state_dict().items()})
    launches = conv_mod.conv3x3.launches - before[0]
    tc = conv_mod.conv3x3.tc_launches - before[1]
    if launches == 0 or tc != (launches if dtype_name != "float32" else 0):
        fail(f"small step {dtype_name}: {launches} conv3x3 launches, {tc} "
             "through the tensor cores")
    (lc, sc), (lp, sp) = runs["cuda"], runs["cpu"]
    worst = max((sc[k].float() - sp[k].float()).abs().max().item()
                for k in sc)
    if dtype_name != "float32":
        if not (np.all(np.isfinite(lc))
                and np.allclose(lc, lp, rtol=1e-2, atol=0.0)):
            fail(f"small step {dtype_name}: losses on the card {lc} vs CPU "
                 f"{lp}")
    else:
        if not np.allclose(lc, lp, rtol=1e-3, atol=1e-4):
            fail(f"small step: losses on the card {lc} vs CPU {lp}")
        for k in sc:
            if not torch.allclose(sc[k], sp[k], rtol=1e-3, atol=1e-4):
                fail(f"small step: {k} differs between card and CPU by "
                     f"{(sc[k] - sp[k]).abs().max().item()}")
    print(f"CHECK small step {dtype_name} card vs CPU: losses {lc} vs {lp}, "
          f"max abs weight diff {worst:.3e}, conv3x3 launches {launches} "
          f"(tensor cores {tc})", flush=True)


def small_lm_step_agrees(torch, fa) -> None:
    """A small LM (2 layers, d 64, 4 heads, S 128, flash), 2 train steps
    on the card and on the CPU from the same weights and batches: losses
    and weights agree (rtol 1e-3, atol 1e-4)."""
    from ps_pytorch_tpu_torch.models.transformer import TransformerLM
    from ps_pytorch_tpu_torch.optim import SGD
    from ps_pytorch_tpu_torch.parallel.sp import LMTrainStep

    rng = np.random.default_rng(0)
    batches = [rng.integers(0, 256, (4, 128)).astype(np.int32)
               for _ in range(2)]
    runs = {}
    before = fa.flash_dkv.launches
    for dev in ("cuda", "cpu"):
        model = TransformerLM(vocab_size=256, n_layers=2, n_heads=4,
                              d_model=64, max_seq_len=128,
                              attention_impl="flash",
                              generator=torch.Generator().manual_seed(3)
                              ).to(dev)
        step = LMTrainStep(model, SGD(0.1, momentum=0.9))
        losses = [float(step(tok)["loss"]) for tok in batches]
        runs[dev] = (losses, {k: v.detach().cpu() for k, v
                              in model.state_dict().items()})
    if fa.flash_dkv.launches != before + 4:
        fail("small LM step: the card run did not go through the kernels")
    (lc, sc), (lp, sp) = runs["cuda"], runs["cpu"]
    if not np.allclose(lc, lp, rtol=1e-3, atol=1e-4):
        fail(f"small LM step: losses on the card {lc} vs CPU {lp}")
    for k in sc:
        if not torch.allclose(sc[k], sp[k], rtol=1e-3, atol=1e-4):
            fail(f"small LM step: {k} differs between card and CPU by "
                 f"{(sc[k] - sp[k]).abs().max().item()}")
    worst = max((sc[k] - sp[k]).abs().max().item() for k in sc)
    print(f"CHECK small LM step card vs CPU: losses {lc} vs {lp}, max abs "
          f"weight diff {worst:.3e}", flush=True)


def lm_flash_counts(wrappers, steps: int, eval_batches: int, layers: int,
                    remat: bool) -> dict:
    """The counts an LM run should read: a forward launch a layer a step
    (two under remat: the backward recomputes it) and an eval batch, a dq
    and a dk/dv launch a layer a step, nothing else."""
    return want_counts(wrappers,
                       flash_fwd=layers * (steps * (2 if remat else 1)
                                           + eval_batches),
                       flash_dq=layers * steps, flash_dkv=layers * steps)


def flash_by_kind(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if k.startswith("flash")}


def lm_ckpt_main_path(torch, wrappers) -> dict:
    """The full-width LM's checkpoint lifecycle through the entry points a
    user calls: ``train_lm.main --remat --eval-freq 2`` with
    ``ckpt_corrupt`` at step 4, a second ``train_lm.main`` that walks back
    past it to step 2 and trains to 6, ``evaluate.main --once 6``
    (EVAL_LM, through the flash oracle), greedy ``generate.main`` held
    against the argmax of the
    full forward over each prefix on the card; checkpoint bytes, save and
    load seconds, and flash launches by kind. Then peak memory of a
    2-step run without and with remat."""
    from ps_pytorch_tpu_torch import evaluate, generate, train_lm
    from ps_pytorch_tpu_torch.models import generate as gen_mod
    from ps_pytorch_tpu_torch.runtime import checkpoint as ckpt
    from ps_pytorch_tpu_torch.runtime.lm_trainer import LMTrainer

    root = tempfile.mkdtemp(prefix="chip_smoke_lmckpt_")
    td = f"{root}/td"
    saves, loads, decoded = [], [], []
    real_ckpt, real_resume = LMTrainer.checkpoint, LMTrainer.maybe_resume
    real_generate = gen_mod.generate

    def timed_checkpoint(self, step):
        t0 = time.monotonic()
        path = real_ckpt(self, step)
        saves.append(round(time.monotonic() - t0, 3))
        return path

    def timed_resume(self):
        t0 = time.monotonic()
        resumed = real_resume(self)
        torch.cuda.synchronize()
        if resumed:
            loads.append(round(time.monotonic() - t0, 3))
        return resumed

    def recorded(model, prompt, **kw):
        out = real_generate(model, prompt, **kw)
        decoded.append((model, prompt, out))
        return out

    LMTrainer.checkpoint, LMTrainer.maybe_resume = (timed_checkpoint,
                                                    timed_resume)
    gen_mod.generate = recorded
    runs = {}
    try:
        common = [*LM_ARGS, "--eval-freq", "2", "--remat", "--train-dir",
                  td, "--device", "cuda"]
        zero_counts(wrappers)
        out = run_entry(train_lm.main, [
            *common, "--max-steps", str(LMCKPT_STEPS), "--fault-spec",
            "ckpt_corrupt:step=4"])
        runs["run"] = read_counts(wrappers)
        if [int(x) for x in re.findall(r"^STEP (\d+) ", out, re.M)] != \
                list(range(1, LMCKPT_STEPS + 1)):
            fail("MAIN-LMCKPT: the first run did not print STEP 1..4")
        if ckpt.committed_steps(td) != [2, 4] or \
                not ckpt.verify_checkpoint(td, 2) or \
                ckpt.verify_checkpoint(td, 4):
            fail(f"MAIN-LMCKPT: checkpoints {ckpt.committed_steps(td)}; "
                 "expected 2 (verified) and 4 (corrupted)")
        nbytes = sum(f.stat().st_size
                     for f in Path(ckpt.checkpoint_path(td, 2)).iterdir())
        zero_counts(wrappers)
        out = run_entry(train_lm.main, [*common, "--max-steps",
                                        str(LMCKPT_RESUMED)])
        runs["resumed"] = read_counts(wrappers)
        if "[ckpt] step 4 failed verification" not in out or \
                "RESUME lm at step 2" not in out:
            fail("MAIN-LMCKPT: the resume did not walk back past the "
                 "corrupt step 4 to step 2")
        if [int(x) for x in re.findall(r"^STEP (\d+) ", out, re.M)] != \
                list(range(3, LMCKPT_RESUMED + 1)):
            fail("MAIN-LMCKPT: the resumed run did not print STEP 3..6")
        if ckpt.committed_steps(td) != [2, 4, 6] or not all(
                ckpt.verify_checkpoint(td, k) for k in (2, 4, 6)):
            fail(f"MAIN-LMCKPT: checkpoints {ckpt.committed_steps(td)} "
                 "after the resume; expected 2, 4, 6, verified")
        zero_counts(wrappers)
        out = run_entry(evaluate.main, ["--train-dir", td, "--once",
                                        str(LMCKPT_RESUMED)])
        found = EVAL_LM_RE.findall(out)
        if len(found) != 1 or found[0][0] != str(LMCKPT_RESUMED):
            fail(f"MAIN-LMCKPT: evaluate.main printed {found}")
        loss, ppl = float(found[0][1]), float(found[0][2])
        want_ppl = math.exp(min(loss, 30.0))
        # The line rounds loss to 1e-6 and perplexity to 1e-3.
        if not (math.isfinite(ppl) and abs(ppl - want_ppl)
                <= 5e-4 + 1e-6 * want_ppl):
            fail(f"MAIN-LMCKPT: perplexity {ppl} is not exp(min({loss}, "
                 f"30)) = {want_ppl}")
        runs["evaluate"] = read_counts(wrappers)
        zero_counts(wrappers)
        out = run_entry(generate.main, [
            "--train-dir", td, "--prompt", "def ", "--n-new",
            str(LMCKPT_NEW), "--temperature", "0"])
        runs["generate"] = read_counts(wrappers)
        model, prompt, tokens = decoded[-1]
        toks = torch.as_tensor(prompt).cuda().long()
        gaps = []
        with torch.no_grad():
            for _ in range(LMCKPT_NEW):
                logits = model(toks)[:, -1]
                top2 = torch.topk(logits, 2, dim=-1).values[0]
                gaps.append(float(top2[0] - top2[1]))
                toks = torch.cat([toks, logits.argmax(-1)[:, None]], dim=1)
        if not torch.equal(toks, tokens):
            at = int((toks != tokens).nonzero()[0, 1])
            fail(f"MAIN-LMCKPT: greedy generate differs from the full "
                 f"forward's argmax at position {at} (top-2 logit gap "
                 f"{gaps[at - prompt.shape[1]]:.3e})")
        text = bytes(tokens[0].cpu().numpy().astype(np.uint8)).decode(
            "utf-8", "replace")
        head, _, body = out.partition("\n")
        if body != text + "\n" or json.loads(head) != {
                "step": LMCKPT_RESUMED, "prompt_bytes": 4,
                "generated_bytes": LMCKPT_NEW}:
            fail("MAIN-LMCKPT: generate.main printed another JSON line or "
                 "text than its tokens")
        # MAIN-SERVE serves these checkpoints (steps 2 and 6).
        kept = tempfile.mkdtemp(prefix="chip_smoke_served_")
        for step in (2, LMCKPT_RESUMED):
            os.rename(ckpt.checkpoint_path(td, step),
                      ckpt.checkpoint_path(kept, step))
    finally:
        LMTrainer.checkpoint, LMTrainer.maybe_resume = (real_ckpt,
                                                        real_resume)
        gen_mod.generate = real_generate
        shutil.rmtree(root, ignore_errors=True)
    want = lm_flash_counts(wrappers, LMCKPT_STEPS, LM_FINAL_BATCHES,
                           LM_LAYERS, remat=True)
    for name in ("run", "resumed"):
        if runs[name] != want:
            fail(f"MAIN-LMCKPT {name} launches {runs[name]}, expected "
                 f"{want}")
    # The evaluator's oracle runs flash (a forward a layer an eval
    # batch); the decode is plain torch.
    if runs["evaluate"] != want_counts(
            wrappers, flash_fwd=LM_LAYERS * LM_FINAL_BATCHES):
        fail(f"MAIN-LMCKPT: evaluate launched {runs['evaluate']}")
    if runs["generate"] != want_counts(wrappers):
        fail(f"MAIN-LMCKPT: generate launched kernels {runs['generate']}")
    print(f"MAIN-LMCKPT checkpoint_bytes {nbytes} save_s {saves} load_s "
          f"{loads} eval {found[0]} greedy {LMCKPT_NEW} tokens equal the "
          f"full forward's argmax (min top-2 gap {min(gaps):.3e}) flash "
          f"launches a run by kind {flash_by_kind(runs['run'])} resumed "
          f"{flash_by_kind(runs['resumed'])} (remat: 2 forwards a layer a "
          f"step) evaluate {flash_by_kind(runs['evaluate'])}", flush=True)
    return dict(runs["run"], resumed=runs["resumed"],
                evaluate=runs["evaluate"], saves=saves, loads=loads,
                checkpoint_bytes=nbytes, served_dir=kept)


class _WatchedStep:
    """An LMTrainer's step, watched for MAIN-LMDIST: the bytes this rank
    hands gloo during each step (``parallel/collectives.stats``), each
    step's loss and, after step ``LMDIST_HELD``, the whole model's
    parameters (every rank takes part in the gather; rank 0 saves them to
    ``<out_dir>/<run>_held.pt``, the run named by its train dir).
    Everything else is the step's."""

    def __init__(self, trainer, rec: dict, out_dir: str):
        self.trainer, self.inner = trainer, trainer.step_fn
        self.rec, self.out_dir = rec, out_dir

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def __call__(self, tokens):
        import torch

        from ps_pytorch_tpu_torch.parallel import collectives
        before = collectives.stats["bytes_sent"]
        out = self.inner(tokens)
        self.rec["step_bytes"].append(collectives.stats["bytes_sent"]
                                      - before)
        self.rec["losses"].append(float(out["loss"]))
        if len(self.rec["losses"]) == LMDIST_HELD:
            params, _ = self.trainer.full_state()
            if not isinstance(params, dict):
                params = params.state_dict()
            if self.trainer.rank == 0:
                run = os.path.basename(self.trainer.cfg.train_dir)
                torch.save({k: v.detach().cpu() for k, v in params.items()},
                           f"{self.out_dir}/{run}_held.pt")
        return out


def lmdist_rank_main(argv) -> int:
    """One rank of MAIN-LMDIST, started by the launcher: ``argv`` is the
    output directory, then the runs split at ``--then`` (one process
    group); for each, ``train_lm.run`` with every launch count set to 0
    just before, its steps watched (``_WatchedStep``), then one ``LMDIST``
    line: launches, checkpoints written, losses, step times, bytes a step,
    peak device memory and the evaluation. A part that starts with
    ``LMDIST_EVAL`` is ``evaluate.main`` of the rest instead (the last
    part), then one ``LMDIST-EVAL`` line: its EVAL_LM line, the
    collectives it called and its launches."""
    import torch

    from ps_pytorch_tpu_torch import evaluate, train_lm
    from ps_pytorch_tpu_torch.parallel import collectives
    from ps_pytorch_tpu_torch.runtime import checkpoint as ckpt
    from ps_pytorch_tpu_torch.runtime import lm_trainer

    out_dir, argv = argv[0], argv[1:]
    wrappers = kernel_wrappers()
    saves, rec, probed = [], {}, []
    save_checkpoint = ckpt.save_checkpoint

    def counted(train_dir, step, *args, **kw):
        saves.append(step)
        t0 = time.monotonic()
        path = save_checkpoint(train_dir, step, *args, **kw)
        rec["save_s"] = round(time.monotonic() - t0, 3)
        return path

    ckpt.save_checkpoint = counted
    cls = lm_trainer.LMTrainer
    build = cls.__init__

    def watched(self, *args, **kw):
        build(self, *args, **kw)
        self.step_fn = _WatchedStep(self, rec, out_dir)

    cls.__init__ = watched

    def run_one(part):
        if part[0] == LMDIST_EVAL:
            zero_counts(wrappers)
            calls = collectives.stats["calls"]
            out = io.StringIO()
            with redirect_stdout(out):
                evaluate.main(part[1:])
            print(out.getvalue().strip(), flush=True)
            print("LMDIST-EVAL " + json.dumps({
                "line": out.getvalue().strip(),
                "collectives": collectives.stats["calls"] - calls,
                "launches": read_counts(wrappers)}), flush=True)
            return None
        saves.clear()
        rec.clear()
        rec.update(losses=[], step_bytes=[])
        zero_counts(wrappers)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        trainer, result = train_lm.run(part)
        run_s = time.monotonic() - t0
        if not probed:
            probe_all_reduce()
            probed.append(True)
        print("LMDIST " + json.dumps({
            "run_s": round(run_s, 3),
            "rank": trainer.rank, "mode": trainer.mode,
            "attention": trainer.model.attention_impl,
            "launches": read_counts(wrappers), "saves": saves,
            "losses": rec["losses"], "step_bytes": rec["step_bytes"],
            "save_s": rec.get("save_s"), "step_times": trainer.step_times,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "eval": result}), flush=True)
        return trainer

    in_turn(argv, run_one)
    return 0


def lmdist_step_bytes(mode: str, run_flags=()) -> int:
    """What a rank of MAIN-LMDIST hands gloo a step, counted from the
    shapes (two ranks, f32): sp, one K/V hop a layer forward and one of
    their gradients backward ([2, B, H, S/2, D] each), the boundary
    token, the gradient all-reduce of every parameter and the loss; tp
    (model axis 2, data 1), two all-reduces of [B, S, d] a block forward
    and two backward, the one in front of ``lm_head`` backward, the
    vocab-parallel cross-entropy's row max and its two row sums; pp (2
    stages, data 1), a [B/M, S, d] activation or its gradient a
    microbatch, the edges' gradients over both ranks and the loss; ep
    (MAIN-MOE), two all-to-alls of the [E, C, d] slot buffer a layer
    forward and two backward (C the capacity of a rank's B/2 x S tokens),
    the replicated gradients (all but the experts) and the loss and aux
    sums. With a head count the model axis does not divide (tp7), a tp
    block also all-reduces the zero-padded [B, S, d] q, k and v forward
    (the gather of its column shards) and their gradients backward.
    ``run_flags`` override LM_ARGS' geometry."""
    from ps_pytorch_tpu_torch.models.moe import capacity

    flags = dict(zip(LM_ARGS[::2], LM_ARGS[1::2]))
    flags.update(zip(run_flags[::2], run_flags[1::2]))
    d, heads, vocab, layers, b, s = (int(flags[f"--{k}"]) for k in (
        "lm-d-model", "lm-heads", "lm-vocab", "lm-layers", "batch-size",
        "lm-seq-len"))
    block = 4 * d * d + 2 * (d * 4 * d) + 4 * d + d + 2 * 2 * d
    edges = vocab * d + s * d + 2 * d + vocab * d
    if mode == "ep":
        slots = MOE_EXPERTS * capacity(1, b // 2 * s, MOE_EXPERTS, 1.25)
        replicated = edges + layers * (4 * d * d + 2 * 2 * d
                                       + d * MOE_EXPERTS)
        return layers * 4 * slots * d * 4 + replicated * 4 + 8
    params = edges + layers * block
    rows = b * (s - 1)
    if mode == "sp":
        kv = 2 * b * heads * (s // 2) * (d // heads) * 4
        return 2 * layers * kv + b * 8 + params * 4 + 4
    if mode == "tp":
        act = b * s * d * 4
        gathers = 0 if heads % 2 == 0 else 6 * layers
        return (4 * layers + gathers + 1) * act + rows * 4 + 2 * rows * 4
    act = (b // LMDIST_MICRO) * s * d * 4
    return LMDIST_MICRO * act + edges * 4 + 4


def lmdist_main_path(torch, wrappers) -> dict:
    """MAIN-LMDIST: the LM path's model (LM_ARGS) as two gloo ranks on the
    card through the launcher, one launch, four runs (LMDIST_RUNS): sp
    over both ranks (ring attention), tp, pp of 2 stages x 4 microbatches
    on the flash kernels with remat, and MAIN-MOE, the MoE LM under ep on
    the flash kernels. Fails unless every run prints the same FINAL line
    on both ranks; rank 0 alone commits the step-3 checkpoint; the bytes
    each rank hands gloo a step are the shapes' count; pp and ep launch
    the flash kernels as their schedules say (pp per rank per step:
    forward layers_per_stage x M, doubled under remat, dq and dk/dv
    layers_per_stage x M; ep a layer a step each, and the forward again a
    layer for each batch of the FINAL evaluation, which keeps flash) and
    sp and tp none; ``evaluate.main --once 3`` scores pp's stage-stacked
    checkpoint to its FINAL loss; each run's step-1 loss and step-2
    parameters agree with the one-rank model's (for ep the one-rank MoE in
    two capacity groups); and MAIN-MOE's checks (``moe_checks``). Prints
    each mode's median step, bytes a step, peak memory and the largest
    differences."""
    from ps_pytorch_tpu_torch import evaluate
    from ps_pytorch_tpu_torch.config import config_from_args
    from ps_pytorch_tpu_torch.runtime import checkpoint as ckpt
    from ps_pytorch_tpu_torch.runtime.lm_trainer import LMTrainer
    from ps_pytorch_tpu_torch.tools.profile_capture import card_line

    card = card_line()
    root = tempfile.mkdtemp(prefix="chip_smoke_lmdist_")
    try:
        argv = ["--rank-lmdist", root]
        for i, (mode, flags, _) in enumerate(LMDIST_RUNS):
            steps = LMDIST_RUN_STEPS.get(mode, LMDIST_STEPS)
            argv += ([THEN] if i else []) + [
                *LM_ARGS, *flags, "--max-steps", str(steps), "--eval-freq",
                str(LMDIST_STEPS if steps == LMDIST_STEPS else 0),
                "--log-every", "1",
                "--resume", "false", "--train-dir", f"{root}/{mode}",
                "--device", "cuda"]
        argv += [THEN, LMDIST_EVAL, "--train-dir", f"{root}/sp", "--once",
                 str(LMDIST_STEPS), "--device", "cuda"]
        t0 = time.monotonic()
        logs = launch_ranks(root, 2, argv, "MAIN-LMDIST")
        wall = time.monotonic() - t0
        gloo_probe(logs)
        recs = {}
        for r, log in enumerate(logs):
            sections = run_sections(log, "LM mesh")
            if len(sections) != len(LMDIST_RUNS):
                fail(f"MAIN-LMDIST: rank {r} ran {len(sections)} runs")
            for (mode, _, _), sec in zip(LMDIST_RUNS, sections):
                found = re.findall(r"^LMDIST (.*)$", sec, re.M)
                final = re.findall(r"^FINAL .*$", sec, re.M)
                if len(found) != 1 or len(final) != 1:
                    fail(f"MAIN-LMDIST {mode}: rank {r} printed no LMDIST "
                         "or no FINAL line")
                recs.setdefault(mode, []).append(
                    dict(json.loads(found[0]), final=final[0]))
        per = LM_LAYERS // 2
        out = {}
        for mode, flags, _ in LMDIST_RUNS:
            a, b = recs[mode]
            if a["final"] != b["final"]:
                fail(f"MAIN-LMDIST {mode}: FINAL differs across ranks "
                     f"({a['final']} / {b['final']})")
            saved = [LMDIST_STEPS] if mode not in LMDIST_RUN_STEPS else []
            if [a["saves"], b["saves"]] != [saved, []] or \
                    ckpt.committed_steps(f"{root}/{mode}") != saved:
                fail(f"MAIN-LMDIST {mode}: checkpoints {a['saves']} / "
                     f"{b['saves']}, committed "
                     f"{ckpt.committed_steps(f'{root}/{mode}')}")
            want_bytes = lmdist_step_bytes(a["mode"], flags)
            if any(n != want_bytes for rec in (a, b)
                   for n in rec["step_bytes"]):
                fail(f"MAIN-LMDIST {mode}: bytes a step {a['step_bytes']} /"
                     f" {b['step_bytes']}, the shapes count {want_bytes}")
            # FINAL: tp and pp score through the flash oracle on each
            # rank, ep through its own flash forward, sp through the ring.
            oracle = LM_LAYERS * LM_FINAL_BATCHES
            fwd = per * LMDIST_MICRO * LMDIST_STEPS
            moe = LM_LAYERS * LMDIST_STEPS
            want = want_counts(wrappers, **(
                dict(flash_fwd=2 * fwd + oracle, flash_dq=fwd,
                     flash_dkv=fwd)
                if mode == "pp" else dict(
                    flash_fwd=moe + oracle, flash_dq=moe, flash_dkv=moe)
                if mode == "ep" else dict(flash_fwd=oracle)
                if a["mode"] == "tp" else {}))
            for rec in (a, b):
                if rec["launches"] != want:
                    fail(f"MAIN-LMDIST {mode} rank {rec['rank']}: launches "
                         f"{rec['launches']}, expected {want}")
            out[mode] = a
        # pp's stage-stacked checkpoint through the evaluator.
        printed = run_entry(evaluate.main, [
            "--train-dir", f"{root}/pp", "--once", str(LMDIST_STEPS),
            "--device", "cuda"])
        m = EVAL_LM_RE.search(printed)
        pp_final = float(out["pp"]["final"].split()[2])
        if not m or int(m.group(1)) != LMDIST_STEPS or \
                abs(float(m.group(2)) - pp_final) > 1e-5:
            fail(f"MAIN-LMDIST: EVAL_LM of pp's checkpoint "
                 f"{m and m.group(0)} against its FINAL {pp_final}")
        # sp's checkpoint: evaluate.main on both ranks (the ring over
        # them, in the launch) and in this process (the flash oracle).
        sp_final = float(out["sp"]["final"].split()[2])
        ring = []
        for r, log in enumerate(logs):
            found = re.findall(r"^LMDIST-EVAL (.*)$", log, re.M)
            rec = json.loads(found[0]) if len(found) == 1 else {}
            em = EVAL_LM_RE.search(rec.get("line", ""))
            if not em or int(em.group(1)) != LMDIST_STEPS or \
                    abs(float(em.group(2)) - sp_final) > 1e-4 or \
                    rec["collectives"] < 1 or \
                    rec["launches"] != want_counts(wrappers):
                fail(f"MAIN-LMDIST: rank {r}'s ring evaluation of sp's "
                     f"checkpoint {rec} against its FINAL {sp_final}")
            ring.append(em.group(0))
        zero_counts(wrappers)
        em = EVAL_LM_RE.search(run_entry(evaluate.main, [
            "--train-dir", f"{root}/sp", "--once", str(LMDIST_STEPS),
            "--device", "cuda"]))
        sp_oracle = read_counts(wrappers)
        if not em or abs(float(em.group(2)) - sp_final) > 1e-4 or \
                sp_oracle != want_counts(wrappers, flash_fwd=LM_LAYERS
                                         * LM_FINAL_BATCHES):
            fail(f"MAIN-LMDIST: one process's EVAL_LM of sp's checkpoint "
                 f"{em and em.group(0)} (launches {sp_oracle}) against its "
                 f"FINAL {sp_final}")
        ring_diff = max(abs(float(EVAL_LM_RE.search(x).group(2))
                            - sp_final) for x in ring)
        print(f"MAIN-LMDIST sp's checkpoint scored across the 2 ranks "
              f"(ring) {ring} and in one process (flash oracle) "
              f"{em.group(0)} against FINAL {sp_final:.6f}: |diff| "
              f"{ring_diff:.3e} / {abs(float(em.group(2)) - sp_final):.3e};"
              f" card {card}", flush=True)
        moe = moe_checks(torch, wrappers, f"{root}/ep")
        # The one-rank model on the same weights and batches, once a
        # reference (ep's in two capacity groups, one a rank).
        refs, ref_s = {}, {}
        for ref_flags in dict.fromkeys(flags for _, _, flags in LMDIST_RUNS):
            t0 = time.monotonic()
            torch.cuda.empty_cache()
            ref = LMTrainer(config_from_args(
                [*LM_ARGS, *ref_flags, "--resume", "false",
                 "--eval-freq", "0", "--train-dir", f"{root}/ref"]),
                device="cuda", printer=lambda line: None)
            for mlp in getattr(ref.model, "moe_layers", list)():
                mlp.n_groups = 2
            refs[ref_flags] = (
                [float(ref.step_fn(ref.train_loader.next_batch())["loss"])
                 for _ in range(LMDIST_HELD)],
                {k: v.detach().cpu()
                 for k, v in ref.model.state_dict().items()})
            del ref
            ref_s[ref_flags] = time.monotonic() - t0
        for mode, _, ref_flags in LMDIST_RUNS:
            losses, want = refs[ref_flags]
            loss_tol, rtol, atol = LMDIST_TOLS.get(
                mode, (LMDIST_LOSS_TOL, LMDIST_RTOL, LMDIST_ATOL))
            got = torch.load(f"{root}/{mode}_held.pt")
            rec = out[mode]
            loss_diff = abs(rec["losses"][0] - losses[0])
            if set(got) != set(want) or loss_diff > loss_tol * (
                    1 + abs(losses[0])):
                fail(f"MAIN-LMDIST {mode}: step-1 loss {rec['losses'][0]} "
                     f"against the one-rank {losses[0]}")
            worst = max((got[k] - want[k]).abs().max().item() for k in got)
            for k in got:
                if not torch.allclose(got[k], want[k], rtol=rtol, atol=atol):
                    fail(f"MAIN-LMDIST {mode}: {k} after {LMDIST_HELD} "
                         f"steps differs from the one-rank model by "
                         f"{(got[k] - want[k]).abs().max().item():.3e}")
            a, b = recs[mode]
            print(f"{'MAIN-MOE' if mode == 'ep' else 'MAIN-LMDIST'} {mode} "
                  f"2 gloo ranks attention {rec['attention']}: median step "
                  f"{np.median(a['step_times']):.4f} / "
                  f"{np.median(b['step_times']):.4f} s (steps "
                  f"{a['step_times']} / {b['step_times']}); bytes a rank a "
                  f"step {a['step_bytes'][0]} / {b['step_bytes'][0]}; peak "
                  f"{a['peak_bytes']} / {b['peak_bytes']} B; {a['final']}; "
                  f"step-1 loss {rec['losses'][0]!r} vs one-rank "
                  f"{' '.join(ref_flags[1::2])} {losses[0]!r} (|diff| "
                  f"{loss_diff:.3e}); max |param diff| after {LMDIST_HELD} "
                  f"steps {worst:.3e}; launches {flash_by_kind(a['launches'])}"
                  f" / {flash_by_kind(b['launches'])}; run_s {a['run_s']} / "
                  f"{b['run_s']}; reference_s {ref_s[ref_flags]:.2f}; card "
                  f"{card}", flush=True)
        print(f"MAIN-LMDIST EVAL_LM of pp's stacked checkpoint "
              f"{m.group(0)}; launch_wall_s {wall:.2f}; card {card}",
              flush=True)
        print(f"MAIN-MOE checkpoint_bytes {moe['bytes']} save_s "
              f"{out['ep']['save_s']} (rank 0); run_s "
              f"{out['ep']['run_s']} (rank 0, train_lm.run); checks_s "
              f"{moe['s']:.2f}; "
              f"{moe['eval']} vs the one-group full-attention oracle "
              f"{moe['oracle']!r} (|diff| {moe['eval_diff']:.3e}); greedy "
              f"{MOE_NEW} tokens equal the full forward's argmax in one "
              f"capacity group a token (min top-2 gap {moe['gap']:.3e}); "
              f"card {card}", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return dict({mode: recs[mode][0]["launches"]
                 for mode, _, _ in LMDIST_RUNS}, sp_oracle=sp_oracle)


def moe_checks(torch, wrappers, td: str) -> dict:
    """MAIN-MOE's checkpoint through the entry points: ``evaluate.main
    --once 3`` prints a finite EVAL_LM equal at 1e-4 to the mean
    next-token loss of the validation batches under the one-group,
    full-attention MoE computed here (on ``generate.main``'s model, that
    MoE with the checkpoint in it); greedy ``generate.main`` of
    MOE_NEW tokens equals the argmax of the full forward over each
    prefix in one capacity group a token (decode's grouping, so nothing
    drops). Neither launches a kernel (full attention, plain decode)."""
    import torch.nn.functional as F

    from ps_pytorch_tpu_torch import evaluate, generate
    from ps_pytorch_tpu_torch.config import checkpoint_config
    from ps_pytorch_tpu_torch.data.text import TokenLoader, lm_streams
    from ps_pytorch_tpu_torch.models import generate as gen_mod
    from ps_pytorch_tpu_torch.models.moe import MoETransformerLM
    from ps_pytorch_tpu_torch.runtime import checkpoint as ckpt

    t0 = time.monotonic()
    step = LMDIST_STEPS
    nbytes = sum(f.stat().st_size
                 for f in Path(ckpt.checkpoint_path(td, step)).iterdir())
    zero_counts(wrappers)
    printed = run_entry(evaluate.main, ["--train-dir", td, "--once",
                                        str(step), "--device", "cuda"])
    m = EVAL_LM_RE.search(printed)
    with open(f"{ckpt.checkpoint_path(td, step)}/config.json") as f:
        cfg = checkpoint_config(f.read())
    decoded = []
    real_generate = gen_mod.generate

    def recorded(model, prompt, **kw):
        out = real_generate(model, prompt, **kw)
        decoded.append((model, prompt, out))
        return out

    gen_mod.generate = recorded
    try:
        run_entry(generate.main, [
            "--train-dir", td, "--prompt", "def ", "--n-new", str(MOE_NEW),
            "--temperature", "0", "--device", "cuda"])
    finally:
        gen_mod.generate = real_generate
    if read_counts(wrappers) != want_counts(wrappers):
        fail(f"MAIN-MOE: evaluate and generate launched kernels "
             f"{read_counts(wrappers)}")
    # The oracle: generate's model, the checkpoint in the one-group
    # full-attention MoE, checked to be that before it is used.
    model, prompt, tokens = decoded[-1]
    if not isinstance(model, MoETransformerLM) or any(
            mlp.n_groups != 1 for mlp in model.moe_layers()) or \
            model.attention_impl != "full":
        fail("MAIN-MOE: generate's model is not the one-group "
             "full-attention MoE")
    _, val = lm_streams(cfg)
    losses = []
    with torch.no_grad():
        for batch in TokenLoader(val, cfg.batch_size, cfg.lm_seq_len,
                                 seed=0, shuffle=False).epoch(0):
            t = torch.as_tensor(batch).cuda().long()
            logits, _ = model(t)
            losses.append(float(F.cross_entropy(
                logits[:, :-1].reshape(-1, cfg.lm_vocab),
                t[:, 1:].reshape(-1))))
    oracle = sum(losses) / len(losses)
    if not m or int(m.group(1)) != step or \
            not math.isfinite(float(m.group(2))) or \
            abs(float(m.group(2)) - oracle) > 1e-4:
        fail(f"MAIN-MOE: EVAL_LM {m and m.group(0)} against the one-group "
             f"full-attention oracle {oracle}")
    toks = torch.as_tensor(prompt).cuda().long()
    gaps = []
    with torch.no_grad():
        for _ in range(MOE_NEW):
            for mlp in model.moe_layers():
                mlp.n_groups = toks.numel()
            logits = model(toks)[0][:, -1]
            top2 = torch.topk(logits, 2, dim=-1).values[0]
            gaps.append(float(top2[0] - top2[1]))
            toks = torch.cat([toks, logits.argmax(-1)[:, None]], dim=1)
    if not torch.equal(toks, tokens):
        at = int((toks != tokens).nonzero()[0, 1])
        fail(f"MAIN-MOE: greedy generate differs from the full forward's "
             f"argmax at position {at} (top-2 logit gap "
             f"{gaps[at - prompt.shape[1]]:.3e})")
    return {"bytes": nbytes, "eval": m.group(0), "oracle": oracle,
            "eval_diff": abs(float(m.group(2)) - oracle), "gap": min(gaps),
            "s": time.monotonic() - t0}


def http_json(url: str, path: str, body=None, timeout: float = 120.0):
    """(status, JSON body or text) of one GET (``body`` None) or POST."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url + path, data=data, headers={
        "Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            code, payload, ctype = (resp.status, resp.read(),
                                    resp.headers.get("Content-Type", ""))
    except urllib.error.HTTPError as e:
        code, payload, ctype = (e.code, e.read(),
                                e.headers.get("Content-Type", ""))
    return code, (json.loads(payload) if "json" in ctype
                  else payload.decode())


def start_server(root: str, name: str, args) -> tuple:
    """``python -m ps_pytorch_tpu_torch.serve <args>`` from the checkout,
    its output to ``<root>/<name>.log``."""
    import subprocess
    log = f"{root}/{name}.log"
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "ps_pytorch_tpu_torch.serve", *args],
            cwd=str(Path(__file__).resolve().parent), stdout=f,
            stderr=subprocess.STDOUT)
    return proc, log


def server_first_line(proc, log: str, name: str,
                      timeout_s: float = 240.0) -> dict:
    """The first JSON line a serve process printed (its URL and step)."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        for line in Path(log).read_text().splitlines():
            if line.startswith("{"):
                return json.loads(line)
        if proc.poll() is not None:
            fail(f"MAIN-SERVE: {name} exited {proc.returncode}: "
                 f"{Path(log).read_text()[-2000:]}")
        time.sleep(0.2)
    fail(f"MAIN-SERVE: {name} printed no JSON line in {timeout_s} s")


def serve_requests(Request) -> list:
    """MAIN-SERVE's 16 requests: prompts of ``SERVE_PROMPTS`` tokens drawn
    from seed 17 over the vocabulary, ``SERVE_NEW`` new tokens, even ones
    greedy and odd ones sampled at temperature 0.8, top-k 40; seed i."""
    rng = np.random.default_rng(17)
    return [Request(prompt=rng.integers(0, 32000, n).astype(np.int32),
                    n_new=SERVE_NEW, temperature=0.0 if i % 2 == 0 else 0.8,
                    top_k=40, seed=i, rid=f"s{i}")
            for i, n in enumerate(SERVE_PROMPTS)]


def serve_main_path(torch, wrappers, served_dir: str) -> dict:
    """MAIN-SERVE: the full-width LM of MAIN-LMCKPT served on the card.

    In process: MAIN-LMCKPT's step-2 weights in a ``ServingEngine`` at 1,
    4 and 8 slots over ``serve_requests``; every stream must equal the
    port's ``generate`` for the same request token for token, and no
    kernel may launch (the decode is plain torch, full attention). Prints
    the largest |logit difference| between an engine row and generate's
    row for the same token, the smallest greedy top-2 gap, tokens/s at 1
    and 8 slots with TTFT and latency p50/p99 (loadgen's closed loop), ms
    a tick with 1 and 8 live slots, the slot cache's bytes and the peak
    device memory. Over HTTP: ``python -m ps_pytorch_tpu_torch.serve`` on
    a train dir holding step 2: its first line's keys, /v1/generate greedy
    tokens equal to the engine's, /readyz, /healthz, /metrics, /slo,
    /debug/requests; then steps 6 and a corrupt 8 land, and /admin/reload
    while a request is in flight moves the served step 2 -> 6 past 8 and
    the request finishes; SIGTERM drains and exits 0. Fleet: two replicas
    registered in a FileKV directory, replica 1 armed with
    ``replica_kill:served=5``, behind an in-process Router: every request
    completes, the router failed over at least once and ejected the
    killed replica, which died by SIGKILL."""
    import signal

    from ps_pytorch_tpu_torch.config import checkpoint_config
    from ps_pytorch_tpu_torch.models import generate as gen_mod
    from ps_pytorch_tpu_torch.resilience.faults import corrupt_file
    from ps_pytorch_tpu_torch.runtime import checkpoint as ckpt
    from ps_pytorch_tpu_torch.runtime.coordinator import FileKV
    from ps_pytorch_tpu_torch.runtime.lm_eval import (
        build_lm_oracle, restore_lm,
    )
    from ps_pytorch_tpu_torch.serving import engine as engine_mod
    from ps_pytorch_tpu_torch.serving.engine import Request, ServingEngine
    from ps_pytorch_tpu_torch.serving.loadgen import run_closed_loop
    from ps_pytorch_tpu_torch.serving.router import FleetView, Router
    from ps_pytorch_tpu_torch.tools.profile_capture import card_line

    card = card_line()
    root = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    procs = []
    try:
        # One train dir a server, hard links of MAIN-LMCKPT's step 2.
        serve_td, fleet_td, kv_dir = (f"{root}/serve", f"{root}/fleet",
                                      f"{root}/kv")
        for td in (serve_td, fleet_td):
            shutil.copytree(ckpt.checkpoint_path(served_dir, 2),
                            ckpt.checkpoint_path(td, 2),
                            copy_function=os.link)
        # The three processes start while this one decodes in process.
        single, single_log = start_server(root, "serve", [
            "--train-dir", serve_td, "--serve-port", "0", "--serve-slots",
            "8", "--serve-reload-s", "0", "--slo-spec", SERVE_SPEC,
            "--reqtrace-keep", "64", "--reqtrace-sample", "1.0",
            "--device", "cuda"])
        fleet = [start_server(root, f"replica_{rid}", [
            "--train-dir", fleet_td, "--serve-port", "0", "--serve-slots",
            "4", "--serve-reload-s", "0", "--serve-kv-dir", kv_dir,
            "--serve-fleet", "f", "--serve-replica-id", str(rid),
            "--device", "cuda",
            *(("--fault-spec", f"replica_kill:served={FLEET_KILL_AFTER},"
               f"r=1") if rid == 1 else ())]) for rid in (0, 1)]
        procs = [single] + [p for p, _ in fleet]

        with open(f"{ckpt.checkpoint_path(serve_td, 2)}/config.json") as f:
            cfg = checkpoint_config(f.read())
        model, _ = build_lm_oracle(cfg, "cuda")
        ckpt.load_checkpoint(serve_td, 2, lambda tree: restore_lm(
            tree, model))
        param_bytes = sum(p.numel() * 4 for p in model.parameters())

        # generate's streams and logits, request by request.
        ref_logits, ref_tokens = {}, {}
        real_sample = gen_mod._sample

        def recorded(logits, *a):
            ref_logits[current].append(logits[0].clone())
            return real_sample(logits, *a)

        gen_mod._sample = recorded
        try:
            torch.cuda.synchronize()
            t0 = time.monotonic()
            for req in serve_requests(Request):
                current = req.rid
                ref_logits[current] = []
                out = gen_mod.generate(
                    model, req.prompt[None], n_new=SERVE_NEW,
                    temperature=req.temperature, top_k=req.top_k,
                    seed=req.seed)
                ref_tokens[req.rid] = out[0, len(req.prompt):].tolist()
            generate_s = time.monotonic() - t0
        finally:
            gen_mod._sample = real_sample
        gaps = []
        for req in serve_requests(Request)[::2]:
            top2 = torch.topk(torch.stack(ref_logits[req.rid]), 2).values
            gaps.append(float((top2[:, 0] - top2[:, 1]).min()))

        def check_streams(reqs, what):
            for req in reqs:
                want = ref_tokens[req.rid]
                if req.state != "done" or req.tokens != want:
                    at = next((i for i, (a, b) in enumerate(zip(
                        req.tokens, want)) if a != b), None)
                    fail(f"MAIN-SERVE {what}: request {req.rid} "
                         f"(temperature {req.temperature}) state "
                         f"{req.state} differs from generate at token "
                         f"{at}: {req.tokens[:8]}... against {want[:8]}...")

        torch.cuda.reset_peak_memory_stats()
        deltas, counts = {}, {}
        for slots in SERVE_COMPARED:
            eng = ServingEngine(model, slots=slots)
            rows = {}
            real_draw = eng._draw

            def draw(req, row, rows=rows, real_draw=real_draw):
                rows.setdefault(req.rid, []).append(row[0].clone())
                return real_draw(req, row)

            eng._draw = draw
            reqs = serve_requests(Request)
            zero_counts(wrappers)
            eng.run_to_completion(reqs)
            torch.cuda.synchronize()
            counts[slots] = read_counts(wrappers)
            check_streams(reqs, f"{slots} slots")
            deltas[slots] = max(float((torch.stack(rows[r.rid])
                                       - torch.stack(ref_logits[r.rid]))
                                      .abs().max()) for r in reqs)
            if slots == max(SERVE_SLOTS):
                cache_bytes = eng.cache_bytes
            del eng, rows
        for slots, got in counts.items():
            if got != want_counts(wrappers):
                fail(f"MAIN-SERVE {slots} slots launched kernels {got}: the "
                     "decode is plain torch")
        # The servers have loaded before anything is timed here.
        first = server_first_line(single, single_log, "serve")
        firsts = [server_first_line(p, log, f"replica {rid}")
                  for rid, (p, log) in enumerate(fleet)]
        timed = {}
        for slots in SERVE_TIMED:
            eng = ServingEngine(model, slots=slots)
            reqs = serve_requests(Request)
            zero_counts(wrappers)
            timed[slots] = run_closed_loop(eng, reqs)
            counts[slots] = read_counts(wrappers)
            if counts[slots] != want_counts(wrappers):
                fail(f"MAIN-SERVE timed {slots} slots launched kernels")
            check_streams(reqs, f"timed {slots} slots")
            timed[slots]["ticks"] = eng.ticks
            live = [Request(prompt=reqs[8].prompt, n_new=80,
                            temperature=0.0) for _ in range(slots)]
            for r in live:
                eng.admit(r)
            for _ in range(5):
                eng.step()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(50):
                eng.step()
            timed[slots]["tick_ms"] = (time.perf_counter() - t0) * 20.0
            # Least time of a tick: the parameters and the whole slot
            # cache read once (the attention reads every slot's 2048
            # rows, masked or not).
            timed[slots]["tick_bound_ms"] = (
                param_bytes + eng.cache_bytes) / HBM_BYTES_PER_S * 1e3
            while eng.active_count:
                eng.step()
            del eng
        peak = torch.cuda.max_memory_allocated()
        print(f"MAIN-SERVE streams at slots {list(SERVE_SLOTS)} equal "
              f"generate token for token ({len(SERVE_PROMPTS)} requests, "
              f"prompts {SERVE_PROMPTS[0]}-{SERVE_PROMPTS[-1]}, "
              f"{SERVE_NEW} new, half greedy, half temperature 0.8 top-k "
              f"40); max |engine logit - generate logit| by slots "
              f"{ {k: f'{v:.3e}' for k, v in deltas.items()} } (1 slot "
              f"timed, not compared); smallest "
              f"greedy top-2 gap {min(gaps):.3e}; kernel launches 0 "
              f"(flash {flash_by_kind(counts[max(SERVE_SLOTS)])}); card "
              f"{card}", flush=True)
        for slots, st in timed.items():
            print(f"MAIN-SERVE slots {slots}: tokens_per_sec "
                  f"{st['tokens_per_sec']:.1f} wall_s {st['wall_s']:.3f} "
                  f"ticks {st['ticks']} ttft_p50_ms {st['ttft_p50_ms']:.2f} "
                  f"ttft_p99_ms {st['ttft_p99_ms']:.2f} latency_p50_ms "
                  f"{st['latency_p50_ms']:.2f} latency_p99_ms "
                  f"{st['latency_p99_ms']:.2f}; ms a tick with {slots} "
                  f"live {st['tick_ms']:.3f} (bytes bound of a tick "
                  f"{st['tick_bound_ms']:.3f}: parameters and the whole "
                  f"slot cache at {HBM_BYTES_PER_S / 1e12} TB/s); card "
                  f"{card}",
                  flush=True)
        print(f"MAIN-SERVE generate one request at a time: "
              f"{len(SERVE_PROMPTS) * SERVE_NEW / generate_s:.1f} tokens/s; "
              f"slot cache bytes at {max(SERVE_SLOTS)} slots {cache_bytes}, "
              f"parameter bytes {param_bytes}, peak device bytes {peak}",
              flush=True)

        # ---- over HTTP ----
        if list(first) != SERVE_FIRST_KEYS or first["model_step"] != 2 or \
                first["slots"] != 8 or first["slo_spec"] != SERVE_SPEC:
            fail(f"MAIN-SERVE: serve printed {first}")
        url = first["serving"]
        greedy = serve_requests(Request)[2]
        code, out = http_json(url, "/v1/generate", {
            "tokens": greedy.prompt.tolist(), "n_new": SERVE_NEW,
            "temperature": 0.0, "seed": greedy.seed})
        if code != 200 or out["tokens"] != ref_tokens[greedy.rid] or \
                out["model_step"] != 2:
            fail(f"MAIN-SERVE: /v1/generate answered {code} "
                 f"{str(out)[:300]}")
        http_ttft = out["ttft_ms"]
        for path, want in (("/readyz", 200), ("/healthz", 200),
                           ("/metrics", 200), ("/slo", 200),
                           ("/debug/requests", 200)):
            code, body = http_json(url, path)
            if code != want:
                fail(f"MAIN-SERVE: GET {path} answered {code}")
            if path == "/healthz" and (not body["ok"]
                                       or body["model_step"] != 2):
                fail(f"MAIN-SERVE: /healthz {body}")
            if path == "/metrics" and not all(
                    name in body for name in (
                        "serve_requests_total 1",
                        f"serve_tokens_total {SERVE_NEW}",
                        "serve_ttft_s_bucket", "slo_compliance")):
                fail(f"MAIN-SERVE: /metrics lacks the serving counters")
            if path == "/slo" and body["state"] != "ok":
                fail(f"MAIN-SERVE: /slo {body}")
            if path == "/debug/requests" and [
                    r["rid"] for r in body["requests"]] != [out["rid"]]:
                fail(f"MAIN-SERVE: /debug/requests {body}")
        for step in (LMCKPT_RESUMED,):
            shutil.copytree(ckpt.checkpoint_path(served_dir, step),
                            ckpt.checkpoint_path(serve_td, step),
                            copy_function=os.link)
        bad = ckpt.checkpoint_path(serve_td, 8)
        shutil.copytree(ckpt.checkpoint_path(served_dir, LMCKPT_RESUMED),
                        bad, copy_function=os.link)
        os.remove(f"{bad}/state.msgpack")
        shutil.copyfile(
            f"{ckpt.checkpoint_path(served_dir, LMCKPT_RESUMED)}/"
            "state.msgpack", f"{bad}/state.msgpack")
        corrupt_file(f"{bad}/state.msgpack", "flip")
        done = [None] * SERVE_INFLIGHT

        def long_request(i):
            out = http_json(url, "/v1/generate", {
                "tokens": [i + 1] * 16, "n_new": SERVE_INFLIGHT_NEW,
                "temperature": 0.0})
            done[i] = (time.monotonic(), out)

        workers = [threading.Thread(target=long_request, args=(i,))
                   for i in range(SERVE_INFLIGHT)]
        for w in workers:
            w.start()
        deadline = time.monotonic() + 60
        while http_json(url, "/readyz")[1]["active_slots"] == 0:
            if time.monotonic() > deadline:
                fail("MAIN-SERVE: no request took a slot")
            time.sleep(0.01)
        t0 = time.monotonic()
        code, reload = http_json(url, "/admin/reload", {})
        reloaded_t = time.monotonic()
        reload_s = reloaded_t - t0
        for w in workers:
            w.join(timeout=180)
        stats = http_json(url, "/stats")[1]
        # A request admitted under step 2 that finished after the swap
        # was in flight across it.
        across = [d for d in done if d and d[0] > reloaded_t
                  and d[1][1].get("model_step") == 2]
        if reload != {"reloaded": True, "model_step": LMCKPT_RESUMED} or \
                not across or not all(
                    d and d[1][0] == 200
                    and len(d[1][1]["tokens"]) == SERVE_INFLIGHT_NEW
                    for d in done) or \
                stats["model_step"] != LMCKPT_RESUMED or \
                stats["skipped_corrupt"] != 1 or stats["reloads"] != 1:
            codes = [(d[1][0], d[1][1].get("model_step")) if d else None
                     for d in done]
            fail(f"MAIN-SERVE: reload {reload}; requests (code, step) "
                 f"{codes} ({len(across)} across the swap); stats {stats}")
        out_in = across[0][1][1]
        single.send_signal(signal.SIGTERM)
        rc = single.wait(timeout=120)
        log = Path(single_log).read_text()
        if rc != 0 or "[ckpt] step 8 failed verification" not in log:
            fail(f"MAIN-SERVE: serve exited {rc}: {log[-2000:]}")
        print(f"MAIN-SERVE HTTP: first line keys {list(first)}; greedy "
              f"{SERVE_NEW} tokens equal the engine's (ttft_ms "
              f"{http_ttft:.2f}); /readyz /healthz /metrics /slo "
              f"/debug/requests answered; /admin/reload {reload} past the "
              f"corrupt step 8 in {reload_s:.3f} s under "
              f"{SERVE_INFLIGHT} requests of {SERVE_INFLIGHT_NEW} tokens, "
              f"all finished, {len(across)} admitted at step 2 finished "
              f"after the swap (latency_ms {out_in['latency_ms']:.1f}); "
              f"SIGTERM exit {rc}; card {card}", flush=True)

        # ---- the fleet ----
        if [f["replica_id"] for f in firsts] != [0, 1]:
            fail(f"MAIN-SERVE: replicas printed {firsts}")
        view = FleetView(FileKV(kv_dir), "f", lease_timeout_s=60.0)
        router = Router(view, retries=3, backoff_s=0.01)
        if len(view.poll()) != 2:
            fail("MAIN-SERVE: the fleet view does not see two replicas")
        lat, failover_s = [], []
        rng = np.random.default_rng(23)
        for i in range(FLEET_REQUESTS):
            before = router.counters["retries"]
            t0 = time.monotonic()
            code, out = router.route({
                "tokens": rng.integers(0, 32000, 64).tolist(),
                "n_new": FLEET_NEW, "temperature": 0.8, "top_k": 40,
                "seed": i})
            lat.append(time.monotonic() - t0)
            if router.counters["retries"] > before:
                failover_s.append(lat[-1])
            if code != 200 or len(out["tokens"]) != FLEET_NEW:
                fail(f"MAIN-SERVE fleet request {i}: {code} "
                     f"{str(out)[:200]}")
        killed = fleet[1][0].wait(timeout=60)
        kill_log = Path(fleet[1][1]).read_text()
        ejected = [b.id for b in view.backends() if not b.ready]
        if killed != -signal.SIGKILL or (
                f"FAULT replica_kill: SIGKILL replica 1 after "
                f"{FLEET_KILL_AFTER} served") not in kill_log or \
                router.counters["retries"] < 1 or \
                router.counters["failed"] != 0 or ejected != [1]:
            fail(f"MAIN-SERVE fleet: replica 1 exited {killed}, router "
                 f"{router.counters}, ejected {ejected}: "
                 f"{kill_log[-1000:]}")
        fleet[0][0].send_signal(signal.SIGTERM)
        if fleet[0][0].wait(timeout=120) != 0:
            fail("MAIN-SERVE: replica 0 did not drain to exit 0")
        print(f"MAIN-SERVE fleet: {FLEET_REQUESTS} requests through the "
              f"router all 200, replica 1 SIGKILLed after "
              f"{FLEET_KILL_AFTER} served (exit {killed}), router "
              f"{router.counters}, ejections {view.ejections}, failover "
              f"request s {[round(x, 3) for x in failover_s]}, routed "
              f"latency s median {np.median(lat):.3f}; card {card}",
              flush=True)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(served_dir, ignore_errors=True)
    return dict(counts[max(SERVE_SLOTS)], timed=timed, deltas=deltas,
                gap=min(gaps), cache_bytes=cache_bytes, peak=peak,
                reload_s=reload_s, failover_s=failover_s)


def accuracy_lm(torch, wrappers) -> dict:
    """ACCURACY_LM on the card: the recipe's 2000 steps through
    ``train_lm.main`` on the flash kernels, the checkpoint at 2000 scored
    by ``evaluate.main``; perplexity at most 16."""
    from ps_pytorch_tpu_torch import evaluate, train_lm
    from ps_pytorch_tpu_torch.tools import accuracy_run

    recipe = accuracy_run.lm_recipe(ACC_LM_STEPS)
    if recipe[recipe.index("--lm-layers") + 1] != str(ACC_LM_LAYERS):
        fail(f"ACCURACY-LM: the recipe's layers are not {ACC_LM_LAYERS}")
    root = tempfile.mkdtemp(prefix="chip_smoke_acclm_")
    try:
        corpus = f"{root}/corpus.bin"
        nbytes = accuracy_run.write_source_corpus(corpus)
        zero_counts(wrappers)
        t0 = time.monotonic()
        run_entry(train_lm.main, [*recipe, "--lm-attention", "flash",
                                  "--lm-corpus-file", corpus,
                                  "--train-dir", f"{root}/td", "--device",
                                  "cuda"])
        wall = time.monotonic() - t0
        launches = read_counts(wrappers)
        found = EVAL_LM_RE.findall(run_entry(
            evaluate.main, ["--train-dir", f"{root}/td", "--once",
                            str(ACC_LM_STEPS)]))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if len(found) != 1 or not float(found[0][2]) <= ACC_LM_TARGET_PPL:
        fail(f"ACCURACY-LM: EVAL_LM {found}, perplexity above "
             f"{ACC_LM_TARGET_PPL}")
    # train_lm's FINAL evaluation: 8 of the 24 validation batches.
    want = lm_flash_counts(wrappers, ACC_LM_STEPS, 8, ACC_LM_LAYERS,
                           remat=False)
    if launches != want:
        fail(f"ACCURACY-LM launches {launches}, expected {want}")
    print(f"ACCURACY-LM TransformerLM d 128 x 2 layers S 256 batch 16 "
          f"flash, framework source bytes ({nbytes} B), {ACC_LM_STEPS} "
          f"steps: perplexity {found[0][2]} loss {found[0][1]} "
          f"train_wall_s {wall:.2f} launches {flash_by_kind(launches)}",
          flush=True)
    return launches


def kernel_wrappers() -> dict:
    """Every kernel wrapper, by the name the kernels line gives it."""
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


THEN = "--then"


def reset_control_plane(max_steps: int) -> None:
    """Between two synchronous runs in one process group: every rank at a
    barrier, process 0 deletes the first run's Coordinator and heartbeat
    keys from the store (a follower must not read a stale mask, nor the
    leader a stale beat), a second barrier."""
    import torch.distributed as tdist

    from ps_pytorch_tpu_torch.parallel import dist

    tdist.barrier()
    if dist.rank() == 0:
        store = dist.store()
        keys = ["run/step"] + [f"run/mask/{s}"
                               for s in range(1, max_steps + 1)]
        for r in range(dist.world()):
            keys += [f"run/dur/{r}", f"run/hb/{r}", f"run/kill/{r}"]
        for key in keys:
            store.delete_key(key)
    tdist.barrier()


def in_turn(argv, run_one) -> None:
    """Run ``run_one(part)`` for each part of ``argv`` split at ``--then``,
    in one process group: the group stays up between runs (``train.run``
    leaves it only after the last), and the control plane is reset
    between them."""
    from ps_pytorch_tpu_torch.parallel import dist

    parts, cur = [], []
    for arg in argv:
        if arg == THEN:
            parts.append(cur)
            cur = []
        else:
            cur.append(arg)
    parts.append(cur)
    shutdown = dist.shutdown
    dist.shutdown = lambda: None
    try:
        for i, part in enumerate(parts):
            trainer = run_one(part)
            if i + 1 < len(parts):
                reset_control_plane(trainer.cfg.max_steps)
            del trainer
    finally:
        dist.shutdown = shutdown
        shutdown()


def rank_main(argv) -> int:
    """One rank of MAIN-DIST, MAIN-KOFN or MAIN-ZERO, started by the
    launcher: for each run of ``argv`` (runs split at ``--then``, one
    process group), ``train.run`` with every launch count set to 0 just
    before, then one ``RANK`` line: this process's launch counts, the
    checkpoints it wrote, its step, peer-wait and loader times, a sha256 of
    its parameters, the optimizer-state bytes it holds, the reduce-scatter
    route of a sharded update, and its peak device memory."""
    import hashlib

    import torch

    from ps_pytorch_tpu_torch import train
    from ps_pytorch_tpu_torch.parallel.zero import opt_state_bytes
    from ps_pytorch_tpu_torch.runtime import checkpoint as ckpt

    saves = []
    save_checkpoint = ckpt.save_checkpoint

    def counted(train_dir, step, *args, **kw):
        saves.append(step)
        return save_checkpoint(train_dir, step, *args, **kw)

    ckpt.save_checkpoint = counted
    wrappers = kernel_wrappers()

    def run_one(part):
        saves.clear()
        zero_counts(wrappers)
        torch.cuda.reset_peak_memory_stats()
        trainer, result = train.run(part)
        launches = read_counts(wrappers)
        digest = hashlib.sha256()
        for _, p in sorted(trainer.model.named_parameters()):
            digest.update(p.detach().float().cpu().numpy().tobytes())
        path = trainer.metrics.jsonl_path
        print("RANK " + json.dumps({
            "rank": trainer.rank, "launches": launches, "saves": saves,
            "step_times": trainer.step_times,
            "wait_times": trainer.wait_times,
            "data_times": [r["data_time"] for r in read_jsonl(path)]
            if path else [],
            "params_sha256": digest.hexdigest(),
            "opt_state_bytes": opt_state_bytes(trainer.step_fn.opt_state),
            "scatter": getattr(trainer.step_fn, "scatter", None),
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "train_peak_bytes": read_jsonl(path)[-1].get(
                "device_mem_peak_bytes") if path else None,
            "eval": result}), flush=True)
        return trainer

    in_turn(argv, run_one)
    return 0


def probe_all_reduce() -> None:
    """The gloo probe, on one rank of a group already joined: all-reduce
    ResNet-18's gradient size of f32 on the card three times, and print
    the times and whether the sum came out right (a PROBE line)."""
    import torch
    from ps_pytorch_tpu_torch.parallel import dist

    n = 11_173_962
    x = torch.full((n,), float(dist.rank() + 1),
                   device=dist.local_device())
    times = []
    for _ in range(3):
        t0 = time.monotonic()
        torch.distributed.all_reduce(x)
        torch.cuda.synchronize()
        times.append(time.monotonic() - t0)
    want = float(sum(range(1, dist.world() + 1))) * dist.world() ** 2
    print("PROBE " + json.dumps({
        "backend": dist.backend(), "rank": dist.rank(),
        "device": str(x.device), "elements": n,
        "ok": bool((x == want).all()), "all_reduce_s": times}), flush=True)


def launch_ranks(root: str, n: int, argv, phase: str,
                 rc_ok: int = 0) -> list:
    """``tools.launch launch --simulate n --wait`` with this script as the
    entry; echoes the ranks' logs and returns them. The launcher must
    exit ``rc_ok`` (1 where a rank dies on purpose, without FINAL)."""
    import socket

    from ps_pytorch_tpu_torch.tools import launch

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    run_dir = f"{root}/run"
    out = io.StringIO()
    with redirect_stdout(out):
        rc = launch.main(["launch", "--run-dir", run_dir, "--simulate",
                          str(n), "--port", str(port), "--entry",
                          str(Path(__file__).resolve()), "--wait",
                          "--timeout", str(RANK_TIMEOUT_S), "--", *argv])
    logs = [Path(run_dir, f"proc_{r}.log").read_text() for r in range(n)]
    for r, log in enumerate(logs):
        for line in log.splitlines():
            if not line.startswith(("CONFIG", "[W")):
                print(f"{phase} [rank {r}] {line[:400]}", flush=True)
    if rc != rc_ok:
        fail(f"{phase}: the launcher exited {rc}, not {rc_ok} "
             f"({out.getvalue().strip()})")
    return logs


def rank_record(log: str, phase: str) -> dict:
    found = re.findall(r"^RANK (.*)$", log, re.M)
    if len(found) != 1:
        fail(f"{phase}: a rank printed no RANK line")
    return json.loads(found[0])


def gloo_probe(logs) -> None:
    """PROBE-GLOO, on the logs of a launch of two ranks on the one card
    whose ranks ran ``probe_all_reduce`` (MAIN-LMDIST's, where it costs
    no launch of its own): gloo all-reduces a CUDA tensor in this torch
    build, the sum right on both."""
    from ps_pytorch_tpu_torch.tools.profile_capture import card_line

    probes = [json.loads(re.findall(r"^PROBE (.*)$", log, re.M)[0])
              for log in logs]
    if not all(p["ok"] and p["backend"] == "gloo" and p["device"] ==
               "cuda:0" for p in probes):
        fail(f"PROBE-GLOO: gloo did not all-reduce a CUDA tensor right "
             f"({probes})")
    print(f"PROBE-GLOO 2 ranks on cuda:0, {probes[0]['elements']} f32 "
          f"elements: all_reduce_s {[p['all_reduce_s'] for p in probes]} "
          f"card {card_line()}", flush=True)


def dist_main_path(wrappers) -> dict:
    """MAIN-DIST: the CNN path's ResNet-18 as one rank through the
    launcher, NCCL: the step all-reduces at world 1."""
    from ps_pytorch_tpu_torch.tools.profile_capture import card_line

    root = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    try:
        t0 = time.monotonic()
        logs = launch_ranks(root, 1, ["--rank", *DIST_ARGS, "--max-steps",
                                      str(STEPS), "--eval-freq", "0",
                                      "--train-dir", f"{root}/td"],
                            "MAIN-DIST")
        wall = time.monotonic() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if "MESH data=1 model=1 devices=1 backend=nccl device=cuda:0" \
            not in logs[0]:
        fail("MAIN-DIST: MESH does not say backend=nccl")
    rec = rank_record(logs[0], "MAIN-DIST")
    want = want_counts(wrappers, conv3x3=CONV_PER_STEP * STEPS
                       + CONV_PER_EVAL_BATCH * 2, fused_sgd=STEPS)
    print(f"MAIN-DIST world 1 backend nccl step_times_s {rec['step_times']} "
          f"wait_times_s {rec['wait_times']} launch_wall_s {wall:.2f} eval "
          f"{rec['eval']} launches {rec['launches']} card {card_line()}",
          flush=True)
    if rec["launches"] != want:
        fail(f"MAIN-DIST launches {rec['launches']}, expected {want}")
    return rec["launches"]


def run_sections(log: str, marker: str) -> list:
    """A rank's log cut into its runs: each section starts at a line
    that begins with ``marker`` (the trainer's MESH or ASYNC line)."""
    starts = [m.start() for m in re.finditer(f"^{re.escape(marker)}", log,
                                             re.M)]
    return [log[a:b] for a, b in zip(starts, starts[1:] + [len(log)])]


def kofn_main_path(wrappers) -> dict:
    """MAIN-KOFN: the same ResNet-18 (global batch 256, 128 a rank) as two
    ranks on the one card through the launcher (gloo), K-of-N with one
    backup worker and process 0 slowed by 0.3 s a step: the leader's masks
    must drop it from real durations over the KV; process 0 alone writes
    the checkpoints, the ranks end with equal parameters, every conv3x3
    launch takes the tensor cores; then ``evaluate.main`` scores process
    0's last checkpoint. In the same launch, after it, a short sync run
    with the same straggler gives the wait it costs when it is not masked
    out."""
    from ps_pytorch_tpu_torch import evaluate
    from ps_pytorch_tpu_torch.runtime import checkpoint as ckpt
    from ps_pytorch_tpu_torch.tools.profile_capture import card_line

    root = tempfile.mkdtemp(prefix="chip_smoke_kofn_")
    td = f"{root}/td"
    sync_steps = 4
    mesh = "MESH data=2 model=1 devices=2 backend=gloo device=cuda:0"
    try:
        logs = launch_ranks(root, 2, [
            "--rank", *DIST_ARGS, *KOFN_ARGS, "--train-dir", td, THEN,
            *DIST_ARGS, "--inject-step-delay", "0.3",
            "--inject-delay-process", "0", "--max-steps", str(sync_steps),
            "--eval-freq", "0", "--train-dir", f"{root}/sync"], "MAIN-KOFN")
        runs = [run_sections(log, mesh) for log in logs]
        if any(len(r) != 2 for r in runs):
            fail("MAIN-KOFN: MESH does not say backend=gloo on cuda:0 in "
                 "both runs of both ranks")
        kofn = [r[0] for r in runs]
        masks = re.findall(r"^MASK step (\d+) (\[.*\])$", kofn[0], re.M)
        if not masks or masks[-1][1] != "[0, 1]":
            fail(f"MAIN-KOFN: the leader's last MASK is not [0, 1] ({masks})")
        flip = int(masks[-1][0])
        recs = [rank_record(log, "MAIN-KOFN") for log in kofn]
        for r, log in enumerate(kofn):
            steps = [(int(a), float(b)) for a, b in re.findall(
                r"^STEP (\d+) .* participating (\S+) ", log, re.M)]
            if [k for k, _ in steps] != list(range(1, KOFN_STEPS + 1)) or \
                    any(p != 1 for k, p in steps if k >= flip):
                fail(f"MAIN-KOFN rank {r}: STEP lines {steps}")
        if [rec["saves"] for rec in recs] != [[4, 8], []] or \
                ckpt.committed_steps(td) != [4, 8]:
            fail(f"MAIN-KOFN: checkpoints {[rec['saves'] for rec in recs]}, "
                 f"committed {ckpt.committed_steps(td)}; process 0 alone "
                 "must write model_step_4 and model_step_8")
        if recs[0]["params_sha256"] != recs[1]["params_sha256"]:
            fail("MAIN-KOFN: the ranks' parameters differ")
        want = want_counts(wrappers, conv3x3=CONV_PER_STEP * KOFN_STEPS
                           + CONV_PER_EVAL_BATCH * 2, fused_sgd=KOFN_STEPS)
        for r, rec in enumerate(recs):
            if rec["launches"] != want:
                fail(f"MAIN-KOFN rank {r} launches {rec['launches']}, "
                     f"expected {want}")
        card = card_line()
        for r, rec in enumerate(recs):
            print(f"MAIN-KOFN rank {r} step_times_s {rec['step_times']} "
                  f"wait_times_s {rec['wait_times']} card {card}",
                  flush=True)
        print(f"MAIN-KOFN masks {masks} params_sha256 "
              f"{recs[0]['params_sha256']} (equal on both ranks) launches a "
              f"rank {recs[0]['launches']}", flush=True)
        found = EVAL_RE.findall(run_entry(evaluate.main, [
            "--train-dir", td, "--once", str(KOFN_STEPS)]))
        if len(found) != 1 or found[0][0] != str(KOFN_STEPS) or not all(
                math.isfinite(float(x)) for x in found[0][1:]):
            fail(f"MAIN-KOFN: evaluate.main printed no finite EVAL step "
                 f"{KOFN_STEPS}")
        # The same straggler with process 0 in every step (sync): what
        # its 0.3 s costs the other rank before and after it is masked out.
        sync = [rank_record(r[1], "MAIN-KOFN-SYNC") for r in runs]
        want = want_counts(wrappers, conv3x3=CONV_PER_STEP * sync_steps
                           + CONV_PER_EVAL_BATCH * 2, fused_sgd=sync_steps)
        if any(rec["launches"] != want for rec in sync) or \
                sync[0]["params_sha256"] != sync[1]["params_sha256"]:
            fail(f"MAIN-KOFN-SYNC: launches {[r['launches'] for r in sync]} "
                 f"(expected {want}) or the ranks' parameters differ")
        print(f"MAIN-KOFN-SYNC rank 1 step_times_s {sync[1]['step_times']} "
              f"wait_times_s {sync[1]['wait_times']} card {card}",
              flush=True)
        print(f"MAIN-KOFN straggler cost: rank 1's wait a step, median "
              f"over steps 2 on: process 0 in every step (sync) "
              f"{np.median(sync[1]['wait_times'][1:]):.4f} s, masked out "
              f"from step {flip} (kofn) "
              f"{np.median(recs[1]['wait_times'][1:]):.4f} s; step "
              f"{np.median(sync[1]['step_times'][1:]):.4f} s against "
              f"{np.median(recs[1]['step_times'][1:]):.4f} s; card {card}",
              flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return recs[0]["launches"]


def wire_rank_main(argv) -> int:
    """One process of MAIN-WIRE, started by the launcher: for each run of
    ``argv`` (runs split at ``--then``, one process group), ``train.run``
    with every launch count set to 0 just before, then one ``WIRE`` line:
    its launch counts, the checkpoints it wrote, its versions and steps,
    its wire bytes, tick times, publish times and the median of each span
    (wire spans by channel: ``agrad`` gradients, ``aparams`` weights)."""
    from ps_pytorch_tpu_torch import train
    from ps_pytorch_tpu_torch.runtime import async_trainer

    saves = []
    save_checkpoint = async_trainer.ckpt.save_checkpoint

    def counted(train_dir, step, *args, **kw):
        saves.append(step)
        return save_checkpoint(train_dir, step, *args, **kw)

    async_trainer.ckpt.save_checkpoint = counted
    wrappers = kernel_wrappers()

    def run_one(part):
        saves.clear()
        zero_counts(wrappers)
        trainer, result = train.run(part)
        launches = read_counts(wrappers)
        spans = {}
        for ev in trainer.tracer.spans():
            channel = ev.get("args", {}).get("channel", "")
            kind = next((k for k in ("agrad", "aparams") if k in channel),
                        "")
            spans.setdefault(f"{ev['name']}/{kind}" if kind else ev["name"],
                             []).append(ev["dur"])
        rows = read_jsonl(trainer.metrics.jsonl_path)
        own = trainer.transport.grad_ch[trainer.pid]
        print("WIRE " + json.dumps({
            "pid": trainer.pid, "launches": launches, "saves": saves,
            "version": trainer.version, "applied": trainer.applied,
            "own_steps": trainer.own_steps,
            "dropped_stale": trainer.dropped_stale,
            "wire": trainer.transport.wire_stats(),
            "grad_bytes_per_submission":
            own.bytes_out / max(own.publishes, 1),
            "tick_s": [r["step_time"] for r in rows],
            "publish_s": [r["publish_s"] for r in rows],
            "span_median_s": {k: float(np.median(v))
                              for k, v in spans.items()},
            "span_count": {k: len(v) for k, v in spans.items()},
            "eval": result}), flush=True)
        return trainer

    in_turn(argv, run_one)
    return 0


def elect_rank_main(argv) -> int:
    """One process of MAIN-ELECT, started by the launcher: process 1 is
    armed with ``leader_kill``; ``train.run`` with every launch count set
    to 0 just before; the counts when this process is promoted, and a
    sha256 of the canonical final parameters taken as it evaluates them.
    Then one ``ELECT`` line (a killed process prints none)."""
    import hashlib
    import os

    from ps_pytorch_tpu_torch import train
    from ps_pytorch_tpu_torch.parallel.async_dp import tree_flatten
    from ps_pytorch_tpu_torch.runtime import async_trainer

    if os.environ["PS_TPU_PROCESS_ID"] == "1":
        argv = [*argv, "--fault-spec", f"leader_kill:step={ELECT_KILL}"]
    wrappers = kernel_wrappers()
    seen = {"promoted": None, "sha": None, "saves": []}
    cls = async_trainer.AsyncTrainer
    promote, evaluate = cls._promote, cls.evaluate
    save_checkpoint = async_trainer.ckpt.save_checkpoint

    def promoted(self, my_version):
        seen["promoted"] = {"ts": time.time(), "version": my_version,
                            "launches": read_counts(wrappers)}
        return promote(self, my_version)

    def evaluated(self, max_batches=None):
        got = self._fetch_canonical()
        digest = hashlib.sha256()
        for leaf in tree_flatten(got[1]["params"])[0]:
            digest.update(np.ascontiguousarray(leaf).tobytes())
        seen["sha"] = digest.hexdigest()
        return evaluate(self, max_batches)

    def counted(train_dir, step, *args, **kw):
        seen["saves"].append(step)
        return save_checkpoint(train_dir, step, *args, **kw)

    cls._promote, cls.evaluate = promoted, evaluated
    async_trainer.ckpt.save_checkpoint = counted
    zero_counts(wrappers)
    trainer, result = train.run(argv)
    print("ELECT " + json.dumps({
        "pid": trainer.pid, "launches": read_counts(wrappers),
        "promoted": seen["promoted"], "params_sha256": seen["sha"],
        "version": trainer.version, "applied": trainer.applied,
        "own_steps": trainer.own_steps, "saves": seen["saves"],
        "epoch": trainer.election.epoch, "eval": result}), flush=True)
    return 0


def elect_main_path(wrappers) -> dict:
    """MAIN-ELECT: ResNet-18 at full width as three processes on the card
    (``ELECT_ARGS``), the leader SIGKILLed at its tick ``ELECT_KILL``. The
    launcher lets the survivors finish (it exits 1: the killed process has
    no FINAL). Fails unless process 1's log ends at its ``FAULT
    leader_kill`` line; exactly one ``ELECTED async leader`` line, from a
    survivor, at an epoch above 1, and no ``DEPOSED`` line; both
    survivors print one FINAL line, equal, and hash the same canonical
    final parameters; the promoted process launched no fused SGD before
    its promotion and one an applied version after it; every conv3x3
    launch took the tensor cores and the quantize kernel ran once a tick
    in each survivor; ``evaluate.main`` scores the new leader's last
    checkpoint, whose meta names its epoch. Prints the election's latency,
    the time from the dead leader's last tick to the takeover, and the
    leader's tick before and after it."""
    from ps_pytorch_tpu_torch import evaluate
    from ps_pytorch_tpu_torch.runtime import checkpoint as ckpt
    from ps_pytorch_tpu_torch.tools.profile_capture import card_line

    root = tempfile.mkdtemp(prefix="chip_smoke_elect_")
    td, card = f"{root}/td", card_line()
    try:
        t0 = time.monotonic()
        logs = launch_ranks(root, 3, [
            "--rank-elect", *ELECT_ARGS, "--train-dir", td,
            "--metrics-file", f"{root}/m.jsonl"], "MAIN-ELECT", rc_ok=1)
        wall = time.monotonic() - t0
        last = logs[1].strip().splitlines()[-1] if logs[1].strip() else ""
        if not re.fullmatch(r"FAULT leader_kill: SIGKILL process 1 "
                            r"\(leader\) at step \d+", last):
            fail(f"MAIN-ELECT: process 1's log ends at {last!r}, not its "
                 "FAULT leader_kill line")
        elected = [(r, m) for r, log in enumerate(logs) for m in re.findall(
            r"^ELECTED async leader process (\d+) epoch (\d+) at version "
            r"(\d+) \(election (\S+)s\)$", log, re.M)]
        if len(elected) != 1 or elected[0][0] not in (0, 2) or \
                int(elected[0][1][0]) != elected[0][0] or \
                int(elected[0][1][1]) < 2:
            fail(f"MAIN-ELECT: elections {elected}; expected one, won by "
                 "a survivor at an epoch above 1")
        if any("DEPOSED" in log for log in logs):
            fail("MAIN-ELECT: a leader was deposed")
        winner, (_, epoch, at_version, latency) = elected[0]
        other = 2 if winner == 0 else 0
        recs = {}
        for r in (0, 2):
            found = re.findall(r"^ELECT (.*)$", logs[r], re.M)
            if len(found) != 1:
                fail(f"MAIN-ELECT: process {r} printed no ELECT line")
            recs[r] = json.loads(found[0])
        finals = [re.findall(r"^FINAL (.*)$", logs[r], re.M) for r in (0, 2)]
        if len(finals[0]) != 1 or finals[0] != finals[1] or not all(
                math.isfinite(float(x)) for x in finals[0][0].split()[1::2]):
            fail(f"MAIN-ELECT: the survivors' FINAL lines {finals}")
        if recs[0]["params_sha256"] != recs[2]["params_sha256"] or \
                not recs[0]["params_sha256"]:
            fail("MAIN-ELECT: the survivors hashed different final "
                 "parameters")
        lead, rest = recs[winner], recs[other]
        if lead["promoted"] is None or rest["promoted"] is not None:
            fail(f"MAIN-ELECT: promotions {lead['promoted']} and "
                 f"{rest['promoted']}")
        before = lead["promoted"]["launches"]["fused_sgd"]
        if before != 0 or lead["launches"]["fused_sgd"] != lead["applied"] \
                or lead["applied"] < 1 or lead["version"] != ELECT_STEPS:
            fail(f"MAIN-ELECT: the promoted process launched fused SGD "
                 f"{before} times before its promotion and "
                 f"{lead['launches']['fused_sgd']} in all, applied "
                 f"{lead['applied']} to version {lead['version']}")
        for r, rec in recs.items():
            want = want_counts(
                wrappers, conv3x3=CONV_PER_STEP * rec["own_steps"]
                + CONV_PER_EVAL_BATCH * 2, quantize=rec["own_steps"],
                fused_sgd=rec["applied"] if r == winner else 0)
            if rec["launches"] != want:
                fail(f"MAIN-ELECT process {r}: launches {rec['launches']}, "
                     f"expected {want}")
        steps = ckpt.committed_steps(td)
        meta = json.loads(Path(ckpt.checkpoint_path(td, steps[-1]),
                               "meta.json").read_text())
        if steps[-1] != ELECT_STEPS or lead["saves"][-1:] != [ELECT_STEPS] \
                or meta.get("leader_epoch") != int(epoch):
            fail(f"MAIN-ELECT: checkpoints {steps}, the new leader's "
                 f"{lead['saves']}, meta {meta}")
        found = EVAL_RE.findall(run_entry(evaluate.main, [
            "--train-dir", td, "--once", str(ELECT_STEPS)]))
        if len(found) != 1 or not all(math.isfinite(float(x))
                                      for x in found[0][1:]):
            fail("MAIN-ELECT: evaluate.main printed no finite EVAL")
        rows = {r: read_jsonl(f"{root}/m.jsonl" + (f".p{r}" if r else ""))
                for r in range(3)}
        killed_last = max(row["ts"] for row in rows[1])
        takeover = lead["promoted"]["ts"]
        old_ticks = [row["step_time"] for row in rows[1][1:]]
        new_ticks = [row["step_time"] for row in rows[winner]
                     if row["ts"] > takeover][1:]
        print(f"MAIN-ELECT process 1 (leader, epoch 1) killed at its tick "
              f"{ELECT_KILL}; process {winner} ELECTED epoch {epoch} at "
              f"version {at_version}: election_latency_s {latency} "
              f"failover_s {takeover - killed_last:.3f} (the dead "
              f"leader's last tick to the takeover; the lease is stale "
              f"after 9 s); leader tick_s before {old_ticks} (median "
              f"{np.median(old_ticks):.4f}) after {new_ticks} (median "
              f"{np.median(new_ticks):.4f}); card {card}", flush=True)
        print(f"MAIN-ELECT FINAL {finals[0][0]} params_sha256 "
              f"{lead['params_sha256']} (equal in both survivors) EVAL "
              f"step {ELECT_STEPS} {found[0][1:]} launches process "
              f"{winner} {lead['launches']} (fused_sgd at promotion "
              f"{before}) process {other} {rest['launches']} "
              f"launch_wall_s {wall:.2f} card {card}", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {k: lead["launches"][k] + rest["launches"][k]
            for k in lead["launches"]}


def kvrep_main_path(wrappers) -> dict:
    """MAIN-KVREP: two gloo ranks of ResNet-18 with the control plane on
    three backends (``KVREP_ARGS``, ``--elastic --elastic-leader 1``),
    one of them an HTTP server of ``python -m
    ps_pytorch_tpu_torch.runtime.kvrep`` in a process of its own, under
    ``KVREP_FAULTS``; then, in the same launch, the same run on the static
    control plane (the TCPStore, no election, no faults). Fails unless
    the parameters hash alike on both ranks in both runs (the control
    plane must not change the arithmetic), process 1 published every mask
    of the first run, all ones, and each rank's JSONL ends with
    ``kvrep_ejections`` >= 1, ``kvrep_resyncs`` >= 1, ``kv_giveups`` 0.
    Prints the median step of both runs."""
    import subprocess

    from ps_pytorch_tpu_torch.tools.profile_capture import card_line

    root = tempfile.mkdtemp(prefix="chip_smoke_kvrep_")
    port, card = free_port(), card_line()
    server = subprocess.Popen(
        [sys.executable, "-m", "ps_pytorch_tpu_torch.runtime.kvrep",
         "--port", str(port)], stdout=subprocess.PIPE, text=True,
        cwd=str(Path(__file__).resolve().parent))
    try:
        ready = server.stdout.readline().strip()
        if not ready.startswith(f"KVSERVER ready host=127.0.0.1 port={port}"):
            fail(f"MAIN-KVREP: the HTTP backend printed {ready!r}")
        replicas = f"dir:{root}/a,dir:{root}/b,http://127.0.0.1:{port}"
        t0 = time.monotonic()
        logs = launch_ranks(root, 2, [
            "--rank", *KVREP_ARGS, "--elastic", "--elastic-leader", "1",
            "--leader-lease-s", "10", "--kv-replicas", replicas,
            "--kv-resync-s", "0.05", "--fault-spec", KVREP_FAULTS,
            "--train-dir", f"{root}/kvrep", "--metrics-file",
            f"{root}/kvrep.jsonl", THEN, *KVREP_ARGS, "--train-dir",
            f"{root}/static", "--metrics-file", f"{root}/static.jsonl"],
            "MAIN-KVREP")
        wall = time.monotonic() - t0
        mesh = "MESH data=2 model=1 devices=2 backend=gloo device=cuda:0"
        runs = [run_sections(log, mesh) for log in logs]
        if any(len(r) != 2 for r in runs):
            fail("MAIN-KVREP: MESH does not say gloo on cuda:0 in both runs "
                 "of both ranks")
        recs = [[rank_record(x, "MAIN-KVREP") for x in r] for r in runs]
        masks = re.findall(r"^MASK step (\d+) (\[.*\])$", runs[1][0], re.M)
        if [m for _, m in masks] != ["[1, 1]"] or \
                re.search(r"^MASK", runs[0][0], re.M):
            fail(f"MAIN-KVREP: process 1's masks {masks}; process 0 must "
                 "publish none")
        shas = {rec["params_sha256"] for r in recs for rec in r}
        if len(shas) != 1:
            fail(f"MAIN-KVREP: the parameters differ between the runs or "
                 f"the ranks ({shas})")
        want = want_counts(wrappers, conv3x3=CONV_PER_STEP * KVREP_STEPS
                           + CONV_PER_EVAL_BATCH * 2, fused_sgd=KVREP_STEPS)
        if any(rec["launches"] != want for r in recs for rec in r):
            fail(f"MAIN-KVREP: launches "
                 f"{[[x['launches'] for x in r] for r in recs]}, expected "
                 f"{want}")
        keys = ("kvrep_ejections", "kvrep_rejoins", "kvrep_resyncs",
                "kvrep_resync_keys", "kvrep_read_repairs",
                "kvrep_quorum_failures", "kv_backend_kills",
                "kv_backend_wipes", "kv_backend_drops", "kv_retries",
                "kv_giveups", "leader_epoch")
        for r in range(2):
            path = f"{root}/kvrep.jsonl" + (f".p{r}" if r else "")
            row = read_jsonl(path)[-1]
            got = {k: row.get(k) for k in keys}
            if not (got["kvrep_ejections"] or 0) >= 1 or \
                    not (got["kvrep_resyncs"] or 0) >= 1 or \
                    got["kv_giveups"] != 0 or got["kv_backend_wipes"] != 1:
                fail(f"MAIN-KVREP rank {r}: counters {got}")
            print(f"MAIN-KVREP rank {r} counters {got} step_times_s "
                  f"{recs[r][0]['step_times']} (static "
                  f"{recs[r][1]['step_times']}) card {card}", flush=True)
        med = [float(np.median(recs[1][k]["step_times"][1:]))
               for k in (0, 1)]
        print(f"MAIN-KVREP params_sha256 {shas.pop()} (equal in both runs, "
              f"both ranks); median step over steps 2 on, rank 1: quorum "
              f"{med[0]:.4f} s, static {med[1]:.4f} s (ratio "
              f"{med[0] / med[1]:.4f}); launches a rank {want}; "
              f"launch_wall_s {wall:.2f} card {card}", flush=True)
    finally:
        server.kill()
        server.wait(timeout=30)
        shutil.rmtree(root, ignore_errors=True)
    return recs[0][0]["launches"]


def resnet18_wire_trees(torch):
    """ResNet-18 as the sharded updater and the screen see it: its
    parameters and one training step's gradients on the card (bf16,
    ``--conv-impl pallas``, a synthetic CIFAR-10 batch of 256, seeded), as
    JAX-layout leaves in wire order (flax paths sorted, HWIO, [in,out]),
    f32 tensors on the card. -> (paths, param leaves, gradient leaves)."""
    from ps_pytorch_tpu_torch.config import TrainConfig
    from ps_pytorch_tpu_torch.data.augment import input_norm_for
    from ps_pytorch_tpu_torch.data.datasets import DataLoader, load_arrays
    from ps_pytorch_tpu_torch.models import build_model
    from ps_pytorch_tpu_torch.models.convert import jax_path, leaf_layout
    from ps_pytorch_tpu_torch.runtime.multislice import make_slice_grad_fn

    cfg = TrainConfig(network="ResNet18", dataset="synthetic_cifar10",
                      batch_size=BATCH, compute_dtype="bfloat16",
                      conv_impl="pallas", eval_freq=0)
    model = build_model(cfg.network, cfg.num_classes, cfg.compute_dtype,
                        cfg.conv_impl, seed=cfg.seed).cuda()
    norm = input_norm_for(cfg)
    xtr, ytr = load_arrays(cfg.dataset, cfg.data_dir, train=True,
                           seed=cfg.seed)
    loader = DataLoader(xtr, ytr, BATCH, cfg.dataset, train=True,
                        seed=cfg.seed, device_normalize=norm is not None)
    x, y = loader.next_batch()
    grads, _ = make_slice_grad_fn(model, norm)(x, y, key=1)
    params = dict(model.named_parameters())
    names = sorted(params)
    return ([jax_path(n, params[n].dim()) for n in names],
            [leaf_layout(n, params[n].detach(), True).contiguous()
             for n in names],
            [leaf_layout(n, grads[n], True).contiguous() for n in names])


def tree_sha256(tree) -> str:
    import hashlib

    from ps_pytorch_tpu_torch.parallel.async_dp import tree_flatten

    digest = hashlib.sha256()
    for leaf in tree_flatten(tree)[0]:
        if hasattr(leaf, "detach"):
            leaf = leaf.detach().cpu().numpy()
        digest.update(np.ascontiguousarray(leaf, np.float32).tobytes())
    return digest.hexdigest()


def check_zero_wire(torch) -> dict:
    """CHECK zero-wire: ResNet-18's parameters and one step's gradients
    from the card, the same average fed for 2 rounds (scaled 1, 1/2)
    to the port's ZeroWireUpdater at 1, 2 and 3 shards, every owner in
    this process over one in-memory KV (the default 4 MiB bucket edges and
    4 workers): SGD (momentum 0.9, weight decay 5e-4), then Adam. Fails
    unless each optimizer's assembled parameters hash the same at every
    shard count and in every owner, and the largest owner holds at most
    1/N of the optimizer state plus one bucket's. Prints the publish and
    assemble seconds a round."""
    from ps_pytorch_tpu_torch.models.convert import nest
    from ps_pytorch_tpu_torch.parallel.buckets import plan_buckets
    from ps_pytorch_tpu_torch.parallel.zero_wire import ZeroWireUpdater
    from ps_pytorch_tpu_torch.runtime.coordinator import KVStore
    from ps_pytorch_tpu_torch.tools.profile_capture import card_line

    card = card_line()
    paths, params, grads = resnet18_wire_trees(torch)
    host_p = [p.cpu().numpy() for p in params]
    host_g = [g.cpu().numpy() for g in grads]
    bucket = 4 << 20
    max_bucket = max(b.nbytes for b in plan_buckets(host_p, bucket))
    rounds = [nest(paths, [g * np.float32(scale) for g in host_g])
              for scale in (1.0, 0.5)]
    out = {}
    for optimizer, kw in (("sgd", dict(lr=0.1, momentum=0.9,
                                       weight_decay=5e-4)),
                          ("adam", dict(lr=1e-3, weight_decay=5e-4))):
        shas = {}
        for n in (1, 2, 3):
            kv = KVStore()
            ups = [ZeroWireUpdater(inner=None, kv=kv, run_id="zw-chip",
                                   params=nest(paths, host_p),
                                   optimizer=optimizer,
                                   members=list(range(n)), me=m, n_shards=n,
                                   bucket_bytes=bucket, workers=4, **kw)
                   for m in range(n)]
            publish_s, assemble_s = [], []
            for rnd, g in enumerate(rounds):
                t0 = time.perf_counter()
                for u in ups:
                    u.apply_and_publish(g, version=rnd + 1)
                t1 = time.perf_counter()
                trees = [u.assemble_round() for u in ups]
                assemble_s.append(time.perf_counter() - t1)
                publish_s.append(t1 - t0)
            owners = {tree_sha256(t) for t in trees}
            if len(owners) != 1:
                fail(f"CHECK zero-wire {optimizer} {n} shards: the owners "
                     f"assembled different parameters")
            shas[n] = owners.pop()
            state = [u.opt_state_nbytes() for u in ups]
            fields = len(ups[0]._opt.fields)
            limit = sum(state) / n + fields * max_bucket
            if max(state) > limit:
                fail(f"CHECK zero-wire {optimizer} {n} shards: the largest "
                     f"owner holds {max(state)} B of optimizer state, more "
                     f"than 1/N plus one bucket ({limit:.0f})")
            print(f"CHECK zero-wire {optimizer} {n} shards: publish_s a "
                  f"round {[round(t, 4) for t in publish_s]} assemble_s "
                  f"{[round(t, 4) for t in assemble_s]} opt_state_nbytes "
                  f"{state} (bound {limit:.0f}) zw_bytes_out "
                  f"{[u.wire_stats()['zw_bytes_out'] for u in ups]} shard "
                  f"bytes {ups[0].describe()} card {card}", flush=True)
            out[f"{optimizer}_{n}"] = {"publish_s": publish_s,
                                       "assemble_s": assemble_s,
                                       "opt_state_nbytes": state}
        if len(set(shas.values())) != 1:
            fail(f"CHECK zero-wire {optimizer}: params sha256 by shard count "
                 f"{shas}")
        print(f"CHECK zero-wire {optimizer}: params sha256 {shas[1]} equal "
              f"at 1, 2 and 3 shards", flush=True)
    return out


def check_integrity_on_device(torch) -> dict:
    """CHECK integrity: ResNet-18's gradient tree from the card as four
    CUDA contributions (contributor c scaled by 1 + c/100 + t/1000 in
    round t): in round 0 contributor 2 has a NaN in leaf 7, in rounds 1-4
    it is scaled by 1e8, rounds 5-7 are clean. The port's GradIntegrity
    screens them on the card, a second instance their CPU copies (numpy):
    fails unless the admitted ids, the reasons, the quarantine and
    readmission events and the counters are the same, and every
    contributor's norm agrees to a relative 1e-9. Prints the screen's
    time a round on the card."""
    from ps_pytorch_tpu_torch.resilience.integrity import (
        GradIntegrity, contribution_norm,
    )
    from ps_pytorch_tpu_torch.tools.profile_capture import card_line

    _, _, grads = resnet18_wire_trees(torch)
    events = {"cuda": [], "cpu": []}
    ledgers = {dev: GradIntegrity(on_event=lambda *e, d=dev:
                                  events[d].append(e))
               for dev in events}
    screen_ms, worst = [], 0.0
    for t in range(8):
        contrib = []
        for cid in range(4):
            leaves = [g * (1.0 + 0.01 * cid + 0.001 * t) for g in grads]
            if cid == 2 and t == 0:
                leaves[7][0] = float("nan")
            if cid == 2 and 1 <= t <= 4:
                leaves = [g * 1e8 for g in leaves]
            contrib.append((cid, leaves))
        host = [(cid, [g.cpu().numpy() for g in leaves])
                for cid, leaves in contrib]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = ledgers["cuda"].screen(contrib, step=t)
        screen_ms.append(1e3 * (time.perf_counter() - t0))
        want = ledgers["cpu"].screen(host, step=t)
        if got != want:
            fail(f"CHECK integrity round {t}: the card screened {got}, the "
                 f"CPU {want}")
        for (_, dev), (_, cpu) in zip(contrib, host):
            a, b = contribution_norm(dev), contribution_norm(cpu)
            if not (math.isnan(a) and math.isnan(b)):
                worst = max(worst, abs(a - b) / b)
    snaps = {dev: g.snapshot() for dev, g in ledgers.items()}
    kinds = [e[0] for e in events["cuda"]]
    if events["cuda"] != events["cpu"] or snaps["cuda"] != snaps["cpu"] or \
            worst > 1e-9 or "quarantine" not in kinds or \
            "readmit" not in kinds:
        fail(f"CHECK integrity: events {events}, counters {snaps}, norm "
             f"rel diff {worst:.3e}")
    print(f"CHECK integrity ResNet-18 gradient tree x 4 contributors on the "
          f"card vs CPU, 8 rounds: same verdicts, events "
          f"{[(e[0], e[1], e[2]) for e in events['cuda'] if e[0] != 'strike']}"
          f", counters {snaps['cuda']}, norm max rel diff {worst:.3e}; "
          f"screen ms a round on the card {[round(x, 2) for x in screen_ms]}"
          f" (median {np.median(screen_ms):.2f}) card {card_line()}",
          flush=True)
    return {"screen_ms": screen_ms}


def shard_rank_main(argv) -> int:
    """One process of MAIN-SHARD, started by the launcher: process 1 is
    armed with ``leader_kill``; ``train.run`` with every launch count set
    to 0 just before; when this process is promoted, its counts, and the
    sharded step it restored; a sha256 of the canonical final parameters
    as it evaluates them. Then one ``SHARD`` line (a killed process
    prints none)."""
    import os

    from ps_pytorch_tpu_torch import train
    from ps_pytorch_tpu_torch.runtime import async_trainer

    if os.environ["PS_TPU_PROCESS_ID"] == "1":
        argv = [*argv, "--fault-spec", f"leader_kill:step={SHARD_KILL}"]
    wrappers = kernel_wrappers()
    seen = {"promoted": None, "sha": None, "saves": []}
    cls = async_trainer.AsyncTrainer
    promote, evaluate = cls._promote, cls.evaluate
    save_checkpoint = async_trainer.ckpt.save_checkpoint

    def promoted(self, my_version):
        seen["promoted"] = {"ts": time.time(), "version": my_version,
                            "launches": read_counts(wrappers)}
        version = promote(self, my_version)
        seen["promoted"].update(
            zero_step=self.aggregator.step, at_version=version,
            ckpt_step=async_trainer.ckpt.latest_step(self.cfg.train_dir))
        return version

    def evaluated(self, max_batches=None):
        seen["sha"] = tree_sha256(self._fetch_canonical()[1]["params"])
        return evaluate(self, max_batches)

    def counted(train_dir, step, *args, **kw):
        seen["saves"].append(step)
        return save_checkpoint(train_dir, step, *args, **kw)

    cls._promote, cls.evaluate = promoted, evaluated
    async_trainer.ckpt.save_checkpoint = counted
    zero_counts(wrappers)
    trainer, result = train.run(argv)
    ch = trainer.transport.param_ch
    updater = trainer.aggregator if trainer.leader else trainer._zw_reader()
    print("SHARD " + json.dumps({
        "pid": trainer.pid, "launches": read_counts(wrappers),
        "promoted": seen["promoted"], "params_sha256": seen["sha"],
        "version": trainer.version, "applied": trainer.applied,
        "own_steps": trainer.own_steps, "saves": seen["saves"],
        "epoch": trainer.election.epoch, "leader": trainer.leader,
        "zero_step": updater.step, "zw": updater.wire_stats(),
        "param_publishes": ch.publishes,
        "param_publish_bytes": ch.last_publish_bytes,
        "eval": result}), flush=True)
    return 0


def shard_main_path(wrappers) -> dict:
    """MAIN-SHARD: ResNet-18 at full width as three processes on the card
    on the sharded wire update (``SHARD_ARGS``), the leader SIGKILLed at
    its tick ``SHARD_KILL``. The launcher lets the survivors finish (it
    exits 1). Fails unless process 1's log ends at its ``FAULT
    leader_kill`` line; one ``ELECTED`` line, from a survivor, at an epoch
    above 1, and no ``DEPOSED``; both survivors print one equal, finite
    FINAL line and hash the same canonical parameters; the promoted
    leader's last checkpoint carries ``extra_state["zero"]`` with the
    sharded step it restored plus its applied updates, over all 3 shards;
    its channel's parameter publish carries the BatchNorm statistics only;
    no process launched fused SGD (the update runs on the host), every
    conv3x3 launch took the tensor cores, no quantize ran; and
    ``evaluate.main`` scores that checkpoint. Then the in-process leg
    (``shard_slices_leg``). Prints the leader's tick before and after the
    takeover and the publish bytes against the replicated wire's."""
    from ps_pytorch_tpu_torch import evaluate
    from ps_pytorch_tpu_torch.runtime import checkpoint as ckpt
    from ps_pytorch_tpu_torch.tools.profile_capture import card_line

    root = tempfile.mkdtemp(prefix="chip_smoke_shard_")
    td, card = f"{root}/td", card_line()
    try:
        t0 = time.monotonic()
        logs = launch_ranks(root, 3, [
            "--rank-shard", *SHARD_ARGS, "--train-dir", td,
            "--metrics-file", f"{root}/m.jsonl"], "MAIN-SHARD", rc_ok=1)
        wall = time.monotonic() - t0
        last = logs[1].strip().splitlines()[-1] if logs[1].strip() else ""
        if not re.fullmatch(r"FAULT leader_kill: SIGKILL process 1 "
                            r"\(leader\) at step \d+", last):
            fail(f"MAIN-SHARD: process 1's log ends at {last!r}, not its "
                 "FAULT leader_kill line")
        elected = [(r, m) for r, log in enumerate(logs) for m in re.findall(
            r"^ELECTED async leader process (\d+) epoch (\d+) at version "
            r"(\d+) \(election (\S+)s\)$", log, re.M)]
        if len(elected) != 1 or elected[0][0] not in (0, 2) or \
                int(elected[0][1][0]) != elected[0][0] or \
                int(elected[0][1][1]) < 2 or \
                any("DEPOSED" in log for log in logs):
            fail(f"MAIN-SHARD: elections {elected}; expected one, won by a "
                 "survivor at an epoch above 1, and no DEPOSED")
        winner, (_, epoch, at_version, latency) = elected[0]
        other = 2 if winner == 0 else 0
        recs = {}
        for r in (0, 2):
            found = re.findall(r"^SHARD (.*)$", logs[r], re.M)
            if len(found) != 1:
                fail(f"MAIN-SHARD: process {r} printed no SHARD line")
            recs[r] = json.loads(found[0])
        finals = [re.findall(r"^FINAL (.*)$", logs[r], re.M) for r in (0, 2)]
        if len(finals[0]) != 1 or finals[0] != finals[1] or not all(
                math.isfinite(float(x)) for x in finals[0][0].split()[1::2]):
            fail(f"MAIN-SHARD: the survivors' FINAL lines {finals}")
        lead, rest = recs[winner], recs[other]
        if lead["params_sha256"] != rest["params_sha256"] or \
                not lead["params_sha256"] or lead["promoted"] is None or \
                rest["promoted"] is not None or not lead["leader"]:
            fail(f"MAIN-SHARD: hashes {lead['params_sha256']} "
                 f"{rest['params_sha256']}, promotions {lead['promoted']} "
                 f"{rest['promoted']}")
        for r, rec in recs.items():
            want = want_counts(wrappers, conv3x3=CONV_PER_STEP
                               * rec["own_steps"] + CONV_PER_EVAL_BATCH * 2)
            if rec["launches"] != want:
                fail(f"MAIN-SHARD process {r}: launches {rec['launches']}, "
                     f"expected {want} (no fused SGD: the update is on the "
                     "host)")
        steps = ckpt.committed_steps(td)
        zero = ckpt.load_extra_state(td, steps[-1])["zero"]
        restored = lead["promoted"]["zero_step"]
        if steps[-1] != SHARD_STEPS or lead["version"] != SHARD_STEPS or \
                lead["saves"][-1:] != [SHARD_STEPS] or \
                zero["step"] != restored + lead["applied"] or \
                zero["step"] != lead["zero_step"] or \
                sorted(zero["shards"]) != ["0", "1", "2"] or \
                zero["optimizer"] != "sgd" or restored < 2:
            fail(f"MAIN-SHARD: checkpoints {steps}, the new leader's saves "
                 f"{lead['saves']} version {lead['version']} applied "
                 f"{lead['applied']}, restored sharded step {restored}, "
                 f"the last checkpoint's zero step {zero['step']} shards "
                 f"{sorted(zero['shards'])}")
        publish = lead["param_publish_bytes"]
        if not 0 < publish < 1e6:
            fail(f"MAIN-SHARD: the leader's channel publish is {publish} B, "
                 "not the BatchNorm statistics alone")
        found = EVAL_RE.findall(run_entry(evaluate.main, [
            "--train-dir", td, "--once", str(SHARD_STEPS)]))
        if len(found) != 1 or not all(math.isfinite(float(x))
                                      for x in found[0][1:]):
            fail("MAIN-SHARD: evaluate.main printed no finite EVAL")
        rows = {r: read_jsonl(f"{root}/m.jsonl" + (f".p{r}" if r else ""))
                for r in range(3)}
        takeover = lead["promoted"]["ts"]
        old_ticks = [row["step_time"] for row in rows[1][1:]]
        new_ticks = [row["step_time"] for row in rows[winner]
                     if row["ts"] > takeover][1:]
        print(f"MAIN-SHARD process 1 (leader, epoch 1) killed at its tick "
              f"{SHARD_KILL}; process {winner} ELECTED epoch {epoch} at "
              f"version {at_version} (election {latency} s), restored the "
              f"sharded state of checkpoint {lead['promoted']['ckpt_step']} "
              f"(step {restored}), applied {lead['applied']} to version "
              f"{lead['version']}; last checkpoint zero step {zero['step']} "
              f"shards {sorted(zero['shards'])}; leader tick_s before "
              f"{old_ticks} (median {np.median(old_ticks):.4f}) after "
              f"{new_ticks} (median {np.median(new_ticks):.4f}); card {card}",
              flush=True)
        print(f"MAIN-SHARD canonical transport publish {publish} B (bs0 "
              f"only) against the replicated wire's "
              f"{RAW_PARAM_PUBLISH_BYTES:.0f} B of parameters: ratio "
              f"{publish / RAW_PARAM_PUBLISH_BYTES:.2e}; zw shard bytes "
              f"out (leader) {lead['zw']['zw_bytes_out']} in (follower) "
              f"{rest['zw']['zw_bytes_in']}; card {card}", flush=True)
        print(f"MAIN-SHARD FINAL {finals[0][0]} params_sha256 "
              f"{lead['params_sha256']} (equal in both survivors) EVAL step "
              f"{SHARD_STEPS} {found[0][1:]} launches process {winner} "
              f"{lead['launches']} process {other} {rest['launches']} "
              f"launch_wall_s {wall:.2f} card {card}", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {k: lead["launches"][k] + rest["launches"][k]
            for k in lead["launches"]}


def shard_slices_leg(torch, wrappers) -> dict:
    """MAIN-SHARD's in-process leg: two slices of ResNet-18 on
    ``--shard-wire`` (``SHARD_SLICE_ARGS``) for 4 ticks, uninterrupted,
    with the launch counts set to 0 before and read after; then 2 ticks
    with a checkpoint at 2 and a second trainer resumed from it to 4, its
    loaders positioned as the uninterrupted run's (a resume starts them
    over, as in the JAX trainer). Fails unless the resumed trainer
    restores the saved parameters and sharded state and ends bitwise
    where the uninterrupted run ends, its last checkpoint's zero step is
    4, conv3x3 ran 26 times a slice a tick on the tensor cores and fused
    SGD never."""
    from ps_pytorch_tpu_torch.config import config_from_args
    from ps_pytorch_tpu_torch.runtime import MultiSliceTrainer
    from ps_pytorch_tpu_torch.runtime import checkpoint as ckpt
    from ps_pytorch_tpu_torch.tools.profile_capture import card_line

    root = tempfile.mkdtemp(prefix="chip_smoke_shard_slices_")
    try:
        def trainer(td, steps, eval_freq, resume):
            cfg = config_from_args([
                *SHARD_SLICE_ARGS, "--max-steps", str(steps),
                "--eval-freq", str(eval_freq), "--resume",
                "true" if resume else "false", "--train-dir", td])
            return MultiSliceTrainer(cfg, n_slices=2, device="cuda",
                                     printer=lambda line: None)

        zero_counts(wrappers)
        t0 = time.monotonic()
        full = trainer(f"{root}/full", 4, 0, False)
        full.train()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = read_counts(wrappers)
        want = want_counts(wrappers, conv3x3=CONV_PER_STEP * 2 * 4)
        if launches != want:
            fail(f"MAIN-SHARD slices: launches {launches}, expected {want}")
        first = trainer(f"{root}/r", 2, 2, False)
        first.train()
        saved = first.aggregator.state_dict()
        mid = tree_sha256(first._wire_tree(first.params))
        second = trainer(f"{root}/r", 4, 2, True)
        with redirect_stdout(io.StringIO()):
            if not second.maybe_resume() or second.step != 2:
                fail("MAIN-SHARD slices: no resume at step 2")
        restored = second.aggregator.state_dict()
        if tree_sha256(second._wire_tree(second.params)) != mid or \
                restored["step"] != saved["step"] or any(
                    not np.array_equal(a, restored["shards"][k][f])
                    for k, fields in saved["shards"].items()
                    for f, a in fields.items()):
            fail("MAIN-SHARD slices: the resumed trainer does not hold the "
                 "saved parameters and sharded state")
        for loader in second.train_loaders:
            loader.fast_forward(2)
        second.cfg.resume = False
        second.train()
        got = tree_sha256(second._wire_tree(second.params))
        want_sha = tree_sha256(full._wire_tree(full.params))
        zero = ckpt.load_extra_state(f"{root}/r", 4)["zero"]
        if got != want_sha or zero["step"] != 4:
            fail(f"MAIN-SHARD slices: resumed {got} vs uninterrupted "
                 f"{want_sha}, last zero step {zero['step']}")
        print(f"MAIN-SHARD slices 2 x 4 ticks on --shard-wire: resumed at 2 "
              f"(sharded step {restored['step']}, {len(restored['shards'])} "
              f"shards) ends bitwise the uninterrupted run, params sha256 "
              f"{got}; uninterrupted wall {wall:.2f} s launches {launches} "
              f"card {card_line()}", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


def poison_rank_main(argv) -> int:
    """One process of MAIN-POISON, started by the launcher: ``train.run``
    with every launch count set to 0 just before; the leader scrapes its
    own exporter after its last tick (the exporter stops with the run);
    every screen is timed. Then one ``POISON`` line."""
    import urllib.request

    from ps_pytorch_tpu_torch import train
    from ps_pytorch_tpu_torch.resilience import integrity
    from ps_pytorch_tpu_torch.runtime import async_trainer

    wrappers = kernel_wrappers()
    seen = {"metrics": "", "screen_s": []}
    cls, gi = async_trainer.AsyncTrainer, integrity.GradIntegrity
    loop, screen = cls._train_loop, gi.screen

    def scraped(self, *args, **kw):
        out = loop(self, *args, **kw)
        if self.leader and self.exporter is not None:
            with urllib.request.urlopen(f"http://127.0.0.1:"
                                        f"{self.exporter.port}/metrics",
                                        timeout=30) as r:
                seen["metrics"] = r.read().decode()
        return out

    def timed(self, *args, **kw):
        t0 = time.perf_counter()
        out = screen(self, *args, **kw)
        seen["screen_s"].append(time.perf_counter() - t0)
        return out

    cls._train_loop, gi.screen = scraped, timed
    zero_counts(wrappers)
    trainer, result = train.run(argv)
    m = re.search(r"^integrity_quarantines_total (\S+)$", seen["metrics"],
                  re.M)
    rows = read_jsonl(trainer.metrics.jsonl_path)
    print("POISON " + json.dumps({
        "pid": trainer.pid, "launches": read_counts(wrappers),
        "version": trainer.version, "applied": trainer.applied,
        "own_steps": trainer.own_steps,
        "integrity": trainer._integrity_snapshot()
        if trainer._integrity is not None else None,
        "faults": trainer.injector.snapshot(),
        "metrics_quarantines": float(m.group(1)) if m else None,
        "screen_s": seen["screen_s"],
        "tick_s": [r["step_time"] for r in rows], "eval": result}),
        flush=True)
    return 0


def poison_main_path(wrappers) -> dict:
    """MAIN-POISON: ResNet-18 at full width as four processes on the card
    (``POISON_ARGS``, global batch 256), process 2 poisoning its own
    int8lat gradients and the leader's gradient reads bit-flipped. Fails
    unless process 0's log has ``INTEGRITY quarantine contributor 2`` and
    ``INTEGRITY readmit contributor 2``, and its ``INTEGRITY pid 0`` line
    screen_rejects >= 3, quarantines >= 1, readmissions >= 1 and
    wire_failures >= 1; its exporter's ``integrity_quarantines_total`` is
    at least 1; all four FINAL losses are finite; every conv3x3 launch
    took the tensor cores, fused SGD ran once an applied version on the
    leader and nowhere else. Prints the screen's time a tick and the
    leader's tick."""
    from ps_pytorch_tpu_torch.tools.profile_capture import card_line

    card = card_line()
    root = tempfile.mkdtemp(prefix="chip_smoke_poison_")
    try:
        t0 = time.monotonic()
        logs = launch_ranks(root, 4, [
            "--rank-poison", *POISON_ARGS, "--train-dir", f"{root}/td",
            "--metrics-file", f"{root}/m.jsonl", "--metrics-port",
            str(free_port_run(4))], "MAIN-POISON")
        wall = time.monotonic() - t0
        lines = {k: re.findall(rf"^INTEGRITY {k} contributor (\d+) at "
                               rf"version (\d+)", logs[0], re.M)
                 for k in ("quarantine", "readmit")}
        summary = re.search(
            r"^INTEGRITY pid 0 screen_rejects (\d+) outlier_rejects (\d+) "
            r"strikes (\d+) quarantines (\d+) readmissions (\d+) "
            r"wire_failures (\d+)$", logs[0], re.M)
        if not summary or not any(c == "2" for c, _ in lines["quarantine"]) \
                or not any(c == "2" for c, _ in lines["readmit"]):
            fail(f"MAIN-POISON: process 0 printed quarantines "
                 f"{lines['quarantine']}, readmissions {lines['readmit']}, "
                 f"summary {summary and summary.group(0)}")
        rejects, outliers, strikes, quarantines, readmits, digests = map(
            int, summary.groups())
        if rejects < 3 or quarantines < 1 or readmits < 1 or digests < 1:
            fail(f"MAIN-POISON: {summary.group(0)}")
        recs = []
        for r, log in enumerate(logs):
            found = re.findall(r"^POISON (.*)$", log, re.M)
            final = re.findall(r"^FINAL loss (\S+) ", log, re.M)
            if len(found) != 1 or len(final) != 1 or \
                    not math.isfinite(float(final[0])):
                fail(f"MAIN-POISON: process {r} printed no POISON line or "
                     f"no finite FINAL ({final})")
            recs.append(json.loads(found[0]))
        lead = recs[0]
        if lead["metrics_quarantines"] is None or \
                lead["metrics_quarantines"] < 1:
            fail(f"MAIN-POISON: the leader's /metrics showed "
                 f"integrity_quarantines_total "
                 f"{lead['metrics_quarantines']}")
        total = {k: 0 for k in lead["launches"]}
        for rec in recs:
            want = want_counts(
                wrappers, conv3x3=CONV_PER_STEP * rec["own_steps"]
                + CONV_PER_EVAL_BATCH * 2,
                fused_sgd=rec["applied"] if rec["pid"] == 0 else 0)
            if rec["launches"] != want:
                fail(f"MAIN-POISON process {rec['pid']}: launches "
                     f"{rec['launches']}, expected {want}")
            for k, v in rec["launches"].items():
                total[k] += v
        screen_ms = [1e3 * x for x in lead["screen_s"]]
        print(f"MAIN-POISON quarantine {lines['quarantine']} readmit "
              f"{lines['readmit']} (contributor, version); screen_rejects "
              f"{rejects} outlier_rejects {outliers} strikes {strikes} "
              f"quarantines {quarantines} readmissions {readmits} "
              f"wire_failures {digests}; /metrics "
              f"integrity_quarantines_total {lead['metrics_quarantines']}; "
              f"process 2 grad_poisons "
              f"{recs[2]['faults'].get('grad_poisons')}, leader "
              f"payload_bitflips {lead['faults'].get('payload_bitflips')}; "
              f"card {card}", flush=True)
        print(f"MAIN-POISON screen ms a tick on the leader (4 int8lat "
              f"contributions on the host): median "
              f"{np.median(screen_ms):.3f} max {max(screen_ms):.3f} over "
              f"{len(screen_ms)} screens; leader tick_s median "
              f"{np.median(lead['tick_s']):.4f}; own_steps "
              f"{[r['own_steps'] for r in recs]} applied {lead['applied']} "
              f"FINAL losses {[r['eval']['loss'] for r in recs]} "
              f"launch_wall_s {wall:.2f} card {card}", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return total


def check_hier(torch) -> dict:
    """CHECK hier: ResNet-18's gradient tree from the card (62 leaves,
    11,173,962 f32) as four CUDA contributions (contributor c scaled by 1 +
    c/100 + t/1000 in round t), int8lat. Fails unless the port's
    HierarchicalAggregator(4, group_size=2) with member EF gives, over two
    rounds, the same averages, info and EF state on them as on their CPU
    copies, bitwise; its first round's average is within one lattice step
    a hop (2^-6 of a leaf's largest value) of the flat
    StaleGradientAggregator's; and the drill's bitwise phase
    (tools/hierarchy_drill.py) passes at that width: group 1 silent for
    steps 8-14, the partition declared at 12 and the regraft at 15, the
    checkpoint at 15 resumed at 16 to 20 to the same bits. Prints the
    group hop's and the root's times."""
    from ps_pytorch_tpu_torch.parallel import hierarchy
    from ps_pytorch_tpu_torch.parallel.async_dp import StaleGradientAggregator
    from ps_pytorch_tpu_torch.tools import hierarchy_drill
    from ps_pytorch_tpu_torch.tools.profile_capture import card_line

    card = card_line()
    paths, params, grads = resnet18_wire_trees(torch)
    names = ["/".join(p) for p in paths]
    size = sum(g.numel() for g in grads)
    if len(grads) != 62 or size != 11_173_962:
        fail(f"CHECK hier: ResNet-18's tree has {len(grads)} leaves, "
             f"{size} values")

    def contrib(c, t):
        return {n: g * (1.0 + 0.01 * c + 0.001 * t)
                for n, g in zip(names, grads)}

    timing = {"hop_s": [], "root_s": []}
    gcls, rcls = hierarchy.GroupAggregator, hierarchy.RootAggregator
    hop, root = gcls.collect_and_reencode, rcls.collect

    def timed_hop(self, *args, **kw):
        t0 = time.perf_counter()
        out = hop(self, *args, **kw)
        timing["hop_s"].append(time.perf_counter() - t0)
        return out

    def timed_root(self, *args, **kw):
        t0 = time.perf_counter()
        out = root(self, *args, **kw)
        timing["root_s"].append(time.perf_counter() - t0)
        return out

    gcls.collect_and_reencode, rcls.collect = timed_hop, timed_root
    try:
        runs = {}
        for where in ("cuda", "cpu"):
            agg = hierarchy.HierarchicalAggregator(
                4, group_size=2, codec="int8lat", error_feedback=True)
            outs = []
            for t in range(2):
                for c in range(4):
                    tree = contrib(c, t)
                    if where == "cpu":
                        tree = {k: v.cpu().numpy() for k, v in tree.items()}
                    agg.submit(c, t, tree)
                avg, info = agg.collect(t)
                outs.append((tree_sha256(avg), info))
            runs[where] = (outs, tree_sha256(_flat_ef(agg.ef_state_dict())))
        if runs["cuda"] != runs["cpu"]:
            fail(f"CHECK hier: CUDA contributions {runs['cuda']} against "
                 f"their CPU copies {runs['cpu']}")
        flat = StaleGradientAggregator(4, compress=True, codec="int8lat")
        tree_h = hierarchy.HierarchicalAggregator(4, group_size=2,
                                                  codec="int8lat")
        for c in range(4):
            flat.submit(c, 0, contrib(c, 0))
            tree_h.submit(c, 0, contrib(c, 0))
        want, _ = flat.collect(0)
        got, _ = tree_h.collect(0)
        worst = 0.0
        for n in names:
            bound = float(np.max(np.abs(want[n]))) * 2.0 ** -6 + 1e-7
            worst = max(worst, float(np.max(np.abs(got[n] - want[n])))
                        / bound)
        if worst > 1.0:
            fail(f"CHECK hier: the tree's average is {worst:.3f} lattice "
                 "steps a hop from the flat average")
        hop_s, root_s = list(timing["hop_s"]), list(timing["root_s"])
        t0 = time.monotonic()
        p0 = {n: p.cpu().numpy() for n, p in zip(names, params)}
        drill = hierarchy_drill._phase_bitwise(
            resume_step=16, total_steps=20, grad=contrib, params0=p0)
        drill_s = time.monotonic() - t0
    finally:
        gcls.collect_and_reencode, rcls.collect = hop, root
    want_events = [["partition", 1, 12, 5], ["regraft", 1, 15, 0]]
    want_counters = {"hops": 20, "partitions": 1, "regrafts": 1,
                     "degraded_steps": 7}
    if not drill["ok"] or drill["events"] != want_events or \
            drill["counters"] != want_counters:
        fail(f"CHECK hier drill bitwise phase: ok {drill['ok']} events "
             f"{drill['events']} counters {drill['counters']}")
    print(f"CHECK hier ResNet-18 gradient tree x 4 CUDA contributions, "
          f"int8lat, 2 groups of 2, member EF, 2 rounds: averages, info and "
          f"EF state bitwise those of the CPU copies "
          f"({runs['cuda'][0][-1][0][:16]}...); the tree within "
          f"{worst:.3f} of a lattice step a hop of the flat average; "
          f"card {card}", flush=True)
    print(f"CHECK hier times: group hop (pool sum, decode, re-encode of "
          f"{size} values) ms {[round(1e3 * x, 1) for x in hop_s]} median "
          f"{1e3 * np.median(hop_s):.1f}; root (2 group payloads summed, "
          f"decoded) ms {[round(1e3 * x, 1) for x in root_s]} median "
          f"{1e3 * np.median(root_s):.1f}; card {card}", flush=True)
    print(f"CHECK hier drill bitwise phase at ResNet-18 width: events "
          f"{drill['events']} counters {drill['counters']}, resumed at 16 "
          f"to 20 bitwise the uninterrupted run (final sha256 "
          f"{drill['final_sha256'][:16]}...), {drill_s:.1f} s", flush=True)
    return {"hop_s": hop_s, "root_s": root_s}


def _flat_ef(state) -> dict:
    """A hier EF state as one flat dict (tier/slice/leaf -> residual)."""
    out = {}
    for tier, d in state.items():
        for k, v in d.items():
            if isinstance(v, dict):
                out.update({f"{tier}/{k}/{i}": r for i, r in v.items()})
            else:
                out[f"{tier}/{k}"] = v
    return out


def hier_rank_main(argv) -> int:
    """One process of MAIN-HIER, started by the launcher: ``train.run``
    with every launch count set to 0 just before, its group hops and
    publishing pumps timed. Then one ``HIERRANK`` line: counts, versions,
    steps, the transport's and the fault plane's counters, the bytes the
    root read from the up-links and one member payload's bytes."""
    from ps_pytorch_tpu_torch import train
    from ps_pytorch_tpu_torch.parallel import hierarchy

    wrappers = kernel_wrappers()
    seen = {"hop_s": [], "pump_s": []}
    gcls, tcls = hierarchy.GroupAggregator, hierarchy.HierarchicalKVTransport
    hop, pump = gcls.collect_and_reencode, tcls.pump

    def timed_hop(self, *args, **kw):
        t0 = time.perf_counter()
        out = hop(self, *args, **kw)
        if out is not None:
            seen["hop_s"].append(time.perf_counter() - t0)
        return out

    def timed_pump(self, *args, **kw):
        t0 = time.perf_counter()
        out = pump(self, *args, **kw)
        if out:
            seen["pump_s"].append(time.perf_counter() - t0)
        return out

    gcls.collect_and_reencode, tcls.pump = timed_hop, timed_pump
    zero_counts(wrappers)
    trainer, result = train.run(argv)
    t = trainer.transport
    rows = read_jsonl(trainer.metrics.jsonl_path)
    faults = dict(trainer.injector.snapshot())
    if trainer._retrier is not None:
        faults.update(trainer._retrier.snapshot())
    print("HIERRANK " + json.dumps({
        "pid": trainer.pid, "launches": read_counts(wrappers),
        "version": trainer.version, "applied": trainer.applied,
        "own_steps": trainer.own_steps, "stats": t.stats,
        "faults": faults, "hop_s": seen["hop_s"], "pump_s": seen["pump_s"],
        "root_bytes_in": sum(ch.bytes_in for ch in t._agg_chans.values())
        if trainer.leader else 0,
        "member_payload_bytes": t._my_chan.bytes_out
        / max(t._my_chan.publishes, 1),
        "tick_s": [r["step_time"] for r in rows], "eval": result}),
        flush=True)
    return 0


def hier_main_path(wrappers) -> dict:
    """MAIN-HIER: ResNet-18 at full width as four processes on the card in
    two groups of two (``HIER_ARGS``), group 1 cut off the KV mid-run.
    Fails unless every process's HIER topology line names groups [[0, 1],
    [2, 3]] with aggregators [0, 2]; process 0 prints ``HIER partition
    group 1`` and then ``HIER regraft group 1``, and its HIERARCHY line
    has partitions, regrafts and degraded_steps >= 1 and groups_healthy
    2; processes 2 and 3 alone count kv_partition_drops; the four FINAL
    lines are equal with a finite loss; every conv3x3 launch took the
    tensor cores (26 an own step, 13 an eval batch) and fused SGD ran once
    an applied root update on the leader and nowhere else; and
    ``evaluate.main`` scores the leader's last checkpoint. Prints the
    root's bytes a version against the flat wire's, the group hop's time
    and the leader's tick."""
    import ast

    from ps_pytorch_tpu_torch import evaluate
    from ps_pytorch_tpu_torch.tools.profile_capture import card_line

    card = card_line()
    root = tempfile.mkdtemp(prefix="chip_smoke_hier_")
    td = f"{root}/td"
    try:
        t0 = time.monotonic()
        logs = launch_ranks(root, 4, [
            "--rank-hier", *HIER_ARGS, "--train-dir", td, "--metrics-file",
            f"{root}/m.jsonl"], "MAIN-HIER")
        wall = time.monotonic() - t0
        for r, log in enumerate(logs):
            m = re.search(rf"^HIER topology pid {r}: (\{{.*\}})$", log, re.M)
            plan = ast.literal_eval(m.group(1)) if m else {}
            groups = [list(range(a, min(a + plan.get("group_size", 0),
                                        plan.get("n_slices", 0))))
                      for a in plan.get("aggregators", [])]
            if groups != [[0, 1], [2, 3]] or plan["gid"] != r // 2:
                fail(f"MAIN-HIER process {r}: topology {plan}")
        lines = [(k, int(g), int(v)) for k, g, v in re.findall(
            r"^HIER (partition|regraft) group (\d+) at version (\d+)",
            logs[0], re.M)]
        kinds = [(k, g) for k, g, _ in lines]
        if ("partition", 1) not in kinds or ("regraft", 1) not in kinds or \
                kinds.index(("partition", 1)) > kinds.index(("regraft", 1)):
            fail(f"MAIN-HIER: process 0's lifecycle lines {lines}")
        summary = re.search(
            r"^HIERARCHY pid 0 gid 0 aggregator (\d) hops (\d+) publishes "
            r"(\d+) failovers (\d+) giveups (\d+) partitions (\d+) "
            r"regrafts (\d+) degraded_steps (\d+) groups_healthy (\d+)$",
            logs[0], re.M)
        if not summary:
            fail("MAIN-HIER: process 0 printed no HIERARCHY summary")
        partitions, regrafts, degraded, healthy = map(
            int, summary.groups()[5:])
        if partitions < 1 or regrafts < 1 or degraded < 1 or healthy != 2:
            fail(f"MAIN-HIER: {summary.group(0)}")
        recs, finals = [], []
        for r, log in enumerate(logs):
            found = re.findall(r"^HIERRANK (.*)$", log, re.M)
            final = re.findall(r"^FINAL (.*)$", log, re.M)
            if len(found) != 1 or len(final) != 1:
                fail(f"MAIN-HIER: process {r} printed no HIERRANK or FINAL")
            recs.append(json.loads(found[0]))
            finals.append(final[0])
        loss = float(finals[0].split()[1])
        if len(set(finals)) != 1 or not math.isfinite(loss):
            fail(f"MAIN-HIER: FINAL lines {finals}")
        drops = [rec["faults"].get("kv_partition_drops", 0) for rec in recs]
        if [d > 0 for d in drops] != [False, False, True, True]:
            fail(f"MAIN-HIER: kv_partition_drops by process {drops}")
        total = {k: 0 for k in recs[0]["launches"]}
        for rec in recs:
            want = want_counts(
                wrappers, conv3x3=CONV_PER_STEP * rec["own_steps"]
                + CONV_PER_EVAL_BATCH * 2,
                fused_sgd=rec["applied"] if rec["pid"] == 0 else 0)
            if rec["launches"] != want:
                fail(f"MAIN-HIER process {rec['pid']}: launches "
                     f"{rec['launches']}, expected {want}")
            for k, v in rec["launches"].items():
                total[k] += v
        lead = recs[0]
        if lead["applied"] != lead["version"] or \
                lead["version"] != HIER_STEPS:
            fail(f"MAIN-HIER: the leader applied {lead['applied']} of "
                 f"{lead['version']} versions")
        found = EVAL_RE.findall(run_entry(evaluate.main, [
            "--train-dir", td, "--once", str(HIER_STEPS)]))
        if len(found) != 1 or not all(math.isfinite(float(x))
                                      for x in found[0][1:]):
            fail("MAIN-HIER: evaluate.main printed no finite EVAL")
        root_per_version = lead["root_bytes_in"] / lead["applied"]
        flat_per_version = 4 * np.mean([r["member_payload_bytes"]
                                        for r in recs])
        hop_ms = [1e3 * x for r in recs for x in r["hop_s"]]
        pump_ms = [1e3 * x for r in recs for x in r["pump_s"]]
        print(f"MAIN-HIER lifecycle {lines} (kind, group, version); "
              f"{summary.group(0)}; kv_partition_drops by process {drops}, "
              f"kv_giveups "
              f"{[r['faults'].get('kv_giveups', 0) for r in recs]}, "
              f"failovers {[r['stats']['failovers'] for r in recs]}; "
              f"FINAL {finals[0]} (equal in all four); card {card}",
              flush=True)
        print(f"MAIN-HIER root bytes read a version {root_per_version:.0f} "
              f"(two group payloads) against the flat wire's "
              f"{flat_per_version:.0f} (four member payloads of "
              f"{flat_per_version / 4:.0f}): ratio "
              f"{root_per_version / flat_per_version:.3f}; group hop ms "
              f"(pool sum, decode, re-encode) median "
              f"{np.median(hop_ms):.1f} over {len(hop_ms)}, the publishing "
              f"pump ms median {np.median(pump_ms):.1f}; leader tick_s "
              f"median {np.median(lead['tick_s'][1:]):.4f}; own_steps "
              f"{[r['own_steps'] for r in recs]} applied {lead['applied']} "
              f"EVAL step {found[0][0]} loss {found[0][1]}; launch_wall_s "
              f"{wall:.2f} card {card}", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return total


def hier_slices_leg(torch, wrappers) -> dict:
    """MAIN-HIER's in-process leg: four slices of ResNet-18 on
    ``--sync-topology hier`` (``HIER_SLICE_ARGS``) for 4 ticks,
    uninterrupted, with the launch counts set to 0 before and read after;
    its checkpoint at 2 resumed by a second trainer to 4, its loaders
    positioned as the uninterrupted run's. Fails
    unless the resumed trainer restores the saved parameters and both
    tiers' EF residuals and ends bitwise where the uninterrupted run
    ends, the last checkpoint's ``"ef"`` holds the members' and both
    groups' residuals, conv3x3 ran 26 times a slice a tick on the tensor
    cores and fused SGD once a tick."""
    from ps_pytorch_tpu_torch.config import config_from_args
    from ps_pytorch_tpu_torch.runtime import MultiSliceTrainer
    from ps_pytorch_tpu_torch.runtime import checkpoint as ckpt
    from ps_pytorch_tpu_torch.tools.profile_capture import card_line

    root = tempfile.mkdtemp(prefix="chip_smoke_hier_slices_")
    try:
        def trainer(td, steps, eval_freq, resume):
            cfg = config_from_args([
                *HIER_SLICE_ARGS, "--max-steps", str(steps),
                "--eval-freq", str(eval_freq), "--resume",
                "true" if resume else "false", "--train-dir", td])
            return MultiSliceTrainer(cfg, n_slices=4, device="cuda",
                                     printer=lambda line: None)

        # The uninterrupted run ticks to 4 and checkpoints at 2 on the
        # way, as train() would with --eval-freq 2.
        zero_counts(wrappers)
        t0 = time.monotonic()
        full = trainer(f"{root}/r", 4, 2, False)
        for _ in range(2):
            full.tick()
        full._checkpoint()
        saved = tree_sha256(_flat_ef(full.aggregator.ef_state_dict()))
        mid = tree_sha256(full.params)
        for _ in range(2):
            full.tick()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = read_counts(wrappers)
        want = want_counts(wrappers, conv3x3=CONV_PER_STEP * 4 * 4,
                           fused_sgd=4)
        if launches != want or full.applied != 4:
            fail(f"MAIN-HIER slices: launches {launches}, expected {want}; "
                 f"applied {full.applied}")
        second = trainer(f"{root}/r", 4, 2, True)
        with redirect_stdout(io.StringIO()):
            if not second.maybe_resume() or second.step != 2:
                fail("MAIN-HIER slices: no resume at step 2")
        if tree_sha256(second.params) != mid or \
                tree_sha256(_flat_ef(second.aggregator.ef_state_dict())) \
                != saved:
            fail("MAIN-HIER slices: the resumed trainer does not hold the "
                 "saved parameters and EF residuals")
        for loader in second.train_loaders:
            loader.fast_forward(2)
        second.cfg.resume = False
        second.train()
        got = tree_sha256(second.params)
        want_sha = tree_sha256(full.params)
        ef = ckpt.load_extra_state(f"{root}/r", 4)["ef"]
        if got != want_sha or sorted(ef) != ["g0", "g1", "members"] or \
                sorted(ef["members"]) != ["0", "1", "2", "3"]:
            fail(f"MAIN-HIER slices: resumed {got} vs uninterrupted "
                 f"{want_sha}, last checkpoint's ef {sorted(ef)}")
        print(f"MAIN-HIER slices 4 x 4 ticks on --sync-topology hier (2 "
              f"groups of 2, int8lat, --ef): resumed at 2 (EF of the "
              f"members and both hops restored) ends bitwise the "
              f"uninterrupted run, params sha256 {got}; uninterrupted wall "
              f"{wall:.2f} s launches {launches} card {card_line()}",
              flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


def free_port_run(n: int) -> int:
    """A base port with ``n`` consecutive free ports above it (one
    exporter a process binds ``metrics_port + pid``)."""
    for _ in range(50):
        base = free_port()
        try:
            socks = []
            for k in range(n):
                sock = socket.socket()
                socks.append(sock)
                sock.bind(("127.0.0.1", base + k))
            return base
        except OSError:
            continue
        finally:
            for sock in socks:
                sock.close()
    fail(f"no {n} consecutive free ports")


def wire_sizes() -> dict:
    """Armoured bytes a gradient submission of ResNet-18 should put on
    the wire, from its parameter sizes: base85 turns 4 bytes into 5; the
    f32 tree (raw npy framing adds a header a leaf) or the int8 form
    (each leaf padded to whole 4096-element blocks: int8 values and one
    f32 scale a block) before blosc, which only shrinks the int8 and
    f32 trees here."""
    from ps_pytorch_tpu_torch.models import build_model
    from ps_pytorch_tpu_torch.ops import quantize as tq

    sizes = [p.numel() for p in build_model("ResNet18").parameters()]
    f32 = 4 * sum(sizes)
    int8 = sum(tq.padded_rows(n) * tq.LANES
               + tq.padded_rows(n) // tq.BLOCK_ROWS * 4 for n in sizes)
    return {"leaves": len(sizes), "f32": f32, "int8": int8,
            "raw": 1.25 * f32, "blosc": 1.25 * f32, "int8_armoured":
            1.25 * int8}


def wire_int8_bytes_agree(torch, tq) -> None:
    """One int8 tree of ResNet-18's gradients (random, seeded, in the JAX
    layout) with injected noise through ``quantize_wire`` on the card (the
    kernel, one launch) and on the CPU (the plain version), each published
    through the bucketed blosc channel into its own store: the chunk
    bytes (sha256 over every key and value) are the same."""
    import hashlib

    from ps_pytorch_tpu_torch.models import build_model
    from ps_pytorch_tpu_torch.models.convert import jax_path, leaf_layout, nest
    from ps_pytorch_tpu_torch.parallel.transport import KVPytreeChannel
    from ps_pytorch_tpu_torch.runtime.async_trainer import quantize_wire
    from ps_pytorch_tpu_torch.runtime.coordinator import KVStore
    from ps_pytorch_tpu_torch.tools.profile_capture import card_line

    params = dict(build_model("ResNet18").named_parameters())
    names = sorted(params)
    gen = torch.Generator(device="cuda").manual_seed(11)
    leaves = [leaf_layout(n, 1e-2 * torch.randn(
        params[n].shape, generator=gen, device="cuda"), True).contiguous()
        for n in names]
    noise = [torch.rand((tq.padded_rows(l.numel()), tq.LANES),
                        generator=gen, device="cuda") for l in leaves]
    paths = [jax_path(n, params[n].dim()) for n in names]
    digests, launched = [], []
    for dev in ("cuda", "cpu"):
        before = tq.quantize_int8.launches
        wire = quantize_wire([l.to(dev) for l in leaves], 42 * 31 + 5,
                             [u.to(dev) for u in noise])
        launched.append(tq.quantize_int8.launches - before)
        tree = nest(paths, wire)
        kv = KVStore()
        ch = KVPytreeChannel(kv, "async-42/agrad/0", tree, codec="blosc",
                             bucket_bytes=4 << 20, workers=4)
        ch.publish(1, tree, meta={"step": 0})
        ch.close()
        h = hashlib.sha256()
        for k in sorted(kv._d):
            if not k.endswith(("/meta", "/ver")):
                h.update(k.encode() + b"\0" + kv._d[k].encode() + b"\0")
        digests.append((h.hexdigest(), ch.bytes_out))
    if launched != [1, 0] or digests[0] != digests[1]:
        fail(f"MAIN-WIRE: the int8 wire of the kernel and the plain version "
             f"differ (launches {launched}, sha256 and bytes {digests})")
    print(f"CHECK wire int8 ResNet-18 gradient tree ({len(names)} leaves) "
          f"kernel (1 launch) and plain version on the CPU, injected noise: "
          f"chunk sha256 {digests[0][0]} equal, armoured bytes "
          f"{digests[0][1]} card {card_line()}", flush=True)


def check_wire_run(wrappers, sizes, card, run, td, logs,
                   wall: float) -> dict:
    """One MAIN-WIRE run's checks on its two processes' log sections (see
    ``wire_main_path``); returns its launches over both processes."""
    name, _, steps, _, resume = run
    codec = name.split("-")[0]
    start = WIRE_INT8_STEPS if resume else 0
    phase = f"MAIN-WIRE {name}"
    recs = []
    for log in logs:
        found = re.findall(r"^WIRE (.*)$", log, re.M)
        if len(found) != 1:
            fail(f"{phase}: a process printed no WIRE line")
        recs.append(json.loads(found[0]))
    finals = [re.findall(r"^FINAL (.*)$", log, re.M) for log in logs]
    if len(finals[0]) != 1 or finals[0] != finals[1] or not all(
            math.isfinite(float(x)) for x in finals[0][0].split()[1::2]):
        fail(f"{phase}: FINAL lines differ or are not finite ({finals})")
    lead, follow = recs
    if [r["pid"] for r in recs] != [0, 1] or lead["version"] != steps or \
            lead["applied"] != steps - start:
        fail(f"{phase}: leader version {lead['version']} applied "
             f"{lead['applied']}, expected {steps} and {steps - start}")
    if [r["saves"] for r in recs] != [WIRE_SAVES[name], []]:
        fail(f"{phase}: checkpoints {[r['saves'] for r in recs]}, "
             f"expected process 0 alone {WIRE_SAVES[name]}")
    if resume and f"RESUME from {td}/model_step_{start} at step {start}" \
            not in logs[0]:
        fail(f"{phase}: the leader printed no RESUME at step {start}")
    total = {key: 0 for key in read_counts(wrappers)}
    for r in recs:
        want = want_counts(
            wrappers, conv3x3=CONV_PER_STEP * r["own_steps"]
            + CONV_PER_EVAL_BATCH * 2,
            quantize=r["own_steps"] if codec == "int8" else 0,
            fused_sgd=r["applied"] if r["pid"] == 0 else 0)
        if r["launches"] != want:
            fail(f"{phase} process {r['pid']}: launches {r['launches']}, "
                 f"expected {want}")
        for key, v in r["launches"].items():
            total[key] += v
        got = r["grad_bytes_per_submission"]
        pred = sizes["int8_armoured" if codec == "int8" else codec]
        if (abs(got / pred - 1) > 0.10 if codec == "raw"
                else got > 1.10 * pred):
            fail(f"{phase} process {r['pid']}: {got:.0f} armoured bytes a "
                 f"submission against {pred:.0f} predicted")
        print(f"{phase} process {r['pid']} own_steps {r['own_steps']} "
              f"version {r['version']} applied {r['applied']} "
              f"dropped_stale {r['dropped_stale']} tick_s {r['tick_s']} "
              f"publish_s {r['publish_s']} card {card}", flush=True)
        print(f"{phase} process {r['pid']} grad_bytes_per_submission "
              f"{got:.0f} predicted {pred:.0f} ratio {got / pred:.4f} wire "
              f"{r['wire']} card {card}", flush=True)
        print(f"{phase} process {r['pid']} span_median_s "
              f"{r['span_median_s']} span_count {r['span_count']} card "
              f"{card}", flush=True)
    print(f"{phase} launch_wall_s {wall:.2f} FINAL {finals[0][0]} (equal in "
          f"both processes) launches {lead['launches']} and "
          f"{follow['launches']} card {card}", flush=True)
    return total


def wire_main_path(wrappers) -> dict:
    """MAIN-WIRE: the CNN path's ResNet-18 at full width as two processes
    on the one card through the launcher, ``--mode async`` one slice a
    process. Each run: both processes print the ASYNC line and the same
    finite FINAL line; the leader's applied updates make its version;
    process 0 alone commits the checkpoints (and the resumed launch prints
    RESUME); every conv3x3 launch takes the tensor cores (26 a step, 13 an
    eval batch); the quantize kernel ran once a tick in each process under
    int8 and fused SGD once an applied version on the leader; each
    process's armoured bytes a gradient submission match the sizes
    (``wire_sizes``). Then ``evaluate.main`` scores the last checkpoint.
    Blosc and raw run in one launch (``WIRE_LAUNCHES``). Returns the
    launches over every run and both processes."""
    from ps_pytorch_tpu_torch import evaluate
    from ps_pytorch_tpu_torch.runtime import checkpoint as ckpt
    from ps_pytorch_tpu_torch.tools.profile_capture import card_line

    card = card_line()
    sizes = wire_sizes()
    print(f"MAIN-WIRE predicted armoured bytes a submission: raw "
          f"{sizes['raw']:.0f} (f32 {sizes['f32']} B, {sizes['leaves']} "
          f"leaves), int8 before blosc {sizes['int8_armoured']:.0f} (int8 "
          f"form {sizes['int8']} B), ratio "
          f"{sizes['int8_armoured'] / sizes['raw']:.4f}", flush=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_wire_")
    total = {name: 0 for name in read_counts(wrappers)}
    try:
        for runs in WIRE_LAUNCHES:
            argv = ["--rank-wire"]
            for name, flags, steps, eval_freq, resume in runs:
                argv += [*([THEN] if len(argv) > 1 else []), *WIRE_ARGS,
                         *flags, "--max-steps", str(steps), "--eval-freq",
                         str(eval_freq), "--resume",
                         "true" if resume else "false", "--train-dir",
                         f"{root}/td_{name.split('-')[0]}", "--metrics-file",
                         f"{root}/{name}.jsonl", "--trace-file",
                         f"{root}/{name}.trace.json"]
            label = " then ".join(run[0] for run in runs)
            t0 = time.monotonic()
            logs = launch_ranks(f"{root}/{runs[0][0]}", 2, argv,
                                f"MAIN-WIRE {label}")
            wall = time.monotonic() - t0
            sections = [run_sections(log, "ASYNC process-slices 2 x 1 "
                                     "devices") for log in logs]
            if any(len(x) != len(runs) for x in sections):
                fail(f"MAIN-WIRE {label}: a process did not print the ASYNC "
                     f"line for each of its {len(runs)} runs")
            for k, run in enumerate(runs):
                for name, v in check_wire_run(
                        wrappers, sizes, card, run, f"{root}/td_"
                        f"{run[0].split('-')[0]}", [x[k] for x in sections],
                        wall).items():
                    total[name] += v
        last = WIRE_INT8_STEPS + 2
        found = EVAL_RE.findall(run_entry(evaluate.main, [
            "--train-dir", f"{root}/td_int8", "--once", str(last)]))
        if len(found) != 1 or found[0][0] != str(last) or not all(
                math.isfinite(float(x)) for x in found[0][1:]):
            fail(f"MAIN-WIRE: evaluate.main printed no finite EVAL step "
                 f"{last}")
        if ckpt.committed_steps(f"{root}/td_int8") != \
                WIRE_SAVES["int8"] + WIRE_SAVES["int8-resumed"]:
            fail(f"MAIN-WIRE: committed "
                 f"{ckpt.committed_steps(f'{root}/td_int8')}")
        print(f"MAIN-WIRE EVAL step {last} {found[0][1:]} launches over "
              f"every run and both processes {total}", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return total


def check_zero_slices(torch, sgd_mod, adam_mod, n: int) -> dict:
    """The fused SGD and Adam kernels on every replica's slice of a padded
    flat buffer of ResNet-18's size, as the sharded update runs them: for
    2 and 3 replicas (slices of ``4 * chunk`` bytes at offsets that are not
    all 16-byte multiples), against the plain versions on the card at
    ``check_sgd``'s and ``check_adam``'s tolerances; the padded tail stays
    zero. These launches are the check's, not a path's."""
    worst = 0.0
    for world in (2, 3):
        chunk = -(-n // world)
        gen = torch.Generator(device="cuda").manual_seed(world)
        flat = torch.zeros(chunk * world, device="cuda")
        flat[:n] = torch.randn(n, device="cuda", generator=gen)
        grad = torch.zeros_like(flat)
        grad[:n] = torch.randn(n, device="cuda", generator=gen)
        for rank in range(world):
            lo = rank * chunk
            p, g = flat[lo:lo + chunk], grad[lo:lo + chunk].clone()
            b = torch.randn(chunk, device="cuda", generator=gen)
            pr, br = p.clone(), b.clone()
            sgd_mod.fused_sgd_update(p, b, g, 0.1, False, momentum=0.9,
                                     dampening=0.0, weight_decay=5e-4,
                                     nesterov=False)
            sgd_mod.fused_sgd_reference(pr, br, g, 0.1, False, 0.9, 0.0,
                                        5e-4, False)
            sgd_ok = torch.allclose(p, pr, rtol=1e-6, atol=1e-6) and \
                torch.allclose(b, br, rtol=1e-6, atol=1e-6)
            sgd_err = max(float((p - pr).abs().max()),
                          float((b - br).abs().max()))
            m = torch.randn(chunk, device="cuda", generator=gen)
            v = torch.rand(chunk, device="cuda", generator=gen)
            vh = v + torch.rand(chunk, device="cuda", generator=gen)
            ref = [t.clone() for t in (p, m, v, vh)]
            adam_mod.fused_adam_update(p, m, v, vh, g, 1e-3, b1=0.9,
                                       b2=0.999, eps=1e-8, weight_decay=0.0)
            adam_mod.fused_adam_reference(*ref, g, 1e-3, 0.9, 0.999, 1e-8,
                                          0.0)
            adam_ok = all(torch.allclose(t, r, rtol=1e-6, atol=1e-7)
                          for t, r in zip((p, m, v, vh), ref))
            adam_err = max(float((t - r).abs().max())
                           for t, r in zip((p, m, v, vh), ref))
            tail = bool((flat[n:] == 0).all())
            print(f"CHECK zero slice world {world} rank {rank} chunk "
                  f"{chunk} offset_bytes % 16 = {(4 * lo) % 16}: fused_sgd "
                  f"max abs err {sgd_err:.3e}, fused_adam {adam_err:.3e}, "
                  f"padded tail zero {tail}", flush=True)
            if not (tail and sgd_ok and adam_ok):
                fail(f"zero slice world {world} rank {rank}: fused SGD err "
                     f"{sgd_err} (rtol/atol 1e-6), fused Adam err "
                     f"{adam_err} (rtol 1e-6, atol 1e-7), tail zero {tail}")
            worst = max(worst, sgd_err, adam_err)
    return {"max_abs_err": worst}


def zero_main_path(wrappers, n_params: int) -> dict:
    """MAIN-ZERO: the CNN path's ResNet-18 (global batch 256, 128 a rank)
    as two gloo ranks on the one card through the launcher, one launch in
    which each rank trains twice in turn: ZeRO-1 (``--shard-update``: the
    fused SGD kernel on each rank's slice) with ``--sync-batchnorm
    --remat --loader-workers 4 --heartbeat-interval-s 0.5``, then the same
    without ``--shard-update``. Two ranks sum in one order either way, so
    the two runs' parameters must agree bitwise, and every rank's hash
    must be equal; masks all ones; conv3x3 launches 39 a step (remat
    recomputes the 13 forwards in the backward) and 13 an eval batch; one
    fused SGD launch a step a rank in both runs; process 0's ZeRO
    checkpoint (the JAX layout: momentum ``[2, chunk]``) scored by
    ``evaluate.main --once``. Prints the optimizer-state bytes a rank
    against the replicated run's and the reduce-scatter route."""
    import torch

    from ps_pytorch_tpu_torch import evaluate
    from ps_pytorch_tpu_torch.parallel.zero import (
        REDUCE_SCATTER, scatter_route,
    )
    from ps_pytorch_tpu_torch.runtime import checkpoint as ckpt
    from ps_pytorch_tpu_torch.tools.profile_capture import card_line

    root = tempfile.mkdtemp(prefix="chip_smoke_zero_")
    card = card_line()
    try:
        t0 = time.monotonic()
        logs = launch_ranks(root, 2, [
            "--rank", *ZERO_ARGS, "--shard-update", "--train-dir",
            f"{root}/zero", "--metrics-file", f"{root}/zero.jsonl", THEN,
            *ZERO_ARGS, "--train-dir", f"{root}/repl", "--metrics-file",
            f"{root}/repl.jsonl"], "MAIN-ZERO")
        wall = time.monotonic() - t0
        recs = []
        for r, log in enumerate(logs):
            if log.count("MESH data=2 model=1 devices=2 backend=gloo "
                         "device=cuda:0") != 2:
                fail(f"MAIN-ZERO rank {r}: MESH does not say gloo on "
                     "cuda:0 twice")
            found = re.findall(r"^RANK (.*)$", log, re.M)
            if len(found) != 2:
                fail(f"MAIN-ZERO rank {r}: {len(found)} RANK lines, not 2")
            recs.append([json.loads(x) for x in found])
        masks = re.findall(r"^MASK step (\d+) (\[.*\])$", logs[0], re.M)
        if [m for _, m in masks] != ["[1, 1]", "[1, 1]"]:
            fail(f"MAIN-ZERO: masks {masks}, expected [1, 1] throughout")
        shas = {rec["params_sha256"] for runs in recs for rec in runs}
        if len(shas) != 1:
            fail(f"MAIN-ZERO: the parameters differ between the ZeRO and "
                 f"the replicated run or between ranks ({shas})")
        want = want_counts(
            wrappers, conv3x3=(CONV_PER_STEP + CONV_PER_EVAL_BATCH)
            * ZERO_STEPS + CONV_PER_EVAL_BATCH * 2, fused_sgd=ZERO_STEPS)
        for r, runs in enumerate(recs):
            for run, rec in zip(("shard-update", "replicated"), runs):
                if rec["launches"] != want:
                    fail(f"MAIN-ZERO rank {r} {run}: launches "
                         f"{rec['launches']}, expected {want}")
        route = scatter_route("gloo", "cuda")
        if any(runs[0]["scatter"] != route for runs in recs):
            fail(f"MAIN-ZERO: reduce-scatter route "
                 f"{[runs[0]['scatter'] for runs in recs]}, expected {route}")
        if [runs[0]["saves"] for runs in recs] != [[ZERO_STEPS], []]:
            fail(f"MAIN-ZERO: checkpoints {[x[0]['saves'] for x in recs]}")
        chunk = -(-n_params // 2)
        zero_b, repl_b = recs[0][0]["opt_state_bytes"], \
            recs[0][1]["opt_state_bytes"]
        if zero_b != 4 * chunk or repl_b != 4 * n_params:
            fail(f"MAIN-ZERO: optimizer-state bytes {zero_b} and {repl_b}, "
                 f"expected {4 * chunk} and {4 * n_params}")
        tree = {}
        ckpt.load_checkpoint(f"{root}/zero", ZERO_STEPS, tree.update)
        if np.shape(tree["opt_state"]["momentum"]) != (2, chunk):
            fail(f"MAIN-ZERO: the checkpoint's momentum is "
                 f"{np.shape(tree['opt_state']['momentum'])}, not the JAX "
                 f"layout (2, {chunk})")
        for r, runs in enumerate(recs):
            for run, rec in zip(("shard-update", "replicated"), runs):
                print(f"MAIN-ZERO rank {r} {run} step_times_s "
                      f"{rec['step_times']} wait_times_s "
                      f"{rec['wait_times']} data_times_s "
                      f"{rec['data_times']} peak_bytes {rec['peak_bytes']} "
                      f"(training steps {rec['train_peak_bytes']}) "
                      f"card {card}", flush=True)
        print(f"MAIN-ZERO gloo reduce_scatter_tensor on CUDA tensors in "
              f"torch {torch.__version__}: exists "
              f"{('gloo', 'cuda') in REDUCE_SCATTER} and ran in every ZeRO "
              f"step (the route, chosen once by the group's backend and "
              f"device: {route}); "
              f"optimizer-state bytes a rank {zero_b} against the "
              f"replicated run's {repl_b} (ratio {zero_b / repl_b:.4f}); "
              f"fused_sgd launches a rank by route: shard-update "
              f"{recs[0][0]['launches']['fused_sgd']} (on slices of "
              f"{chunk}), replicated {recs[0][1]['launches']['fused_sgd']} "
              f"(on {n_params}); params_sha256 {shas.pop()} (equal in "
              f"both runs, both ranks); launch_wall_s {wall:.2f} card "
              f"{card}", flush=True)
        found = EVAL_RE.findall(run_entry(evaluate.main, [
            "--train-dir", f"{root}/zero", "--once", str(ZERO_STEPS)]))
        if len(found) != 1 or not all(math.isfinite(float(x))
                                      for x in found[0][1:]):
            fail("MAIN-ZERO: evaluate.main printed no finite EVAL")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"shard-update": recs[0][0]["launches"],
            "replicated": recs[0][1]["launches"]}


def saved_arrays(make, root: str, name: str, train: bool, seed: int):
    """The files of a synthetic set's x and y under ``root``, made by
    ``make`` (the port's ``datasets._synthetic``) and saved first if no
    process has saved them yet."""
    stem = Path(root, f"{name}-{int(train)}-{seed}")
    paths = (Path(f"{stem}.x.npy"), Path(f"{stem}.y.npy"))
    if not all(p.exists() for p in paths):
        t0 = time.monotonic()
        arrays = make(name, train, seed)
        print(f"ARRAYS {name} train={train} seed {seed}: made in "
              f"{time.monotonic() - t0:.2f} s", flush=True)
        for path, a in zip(paths, arrays):
            tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
            with open(tmp, "wb") as f:
                np.save(f, a)
            os.replace(tmp, path)   # a reader never sees half a file
    return paths


@contextmanager
def arrays_made_once():
    """Inside: each synthetic (data set, split, seed) is made once, by the
    port's own ``datasets._synthetic``, and handed to every later loader as
    a read-only array (the loaders never write into it), so that runs do
    not each draw the synthetic set anew. Where $CHIP_SMOKE_ARRAYS names a
    directory (the script's first process sets it, and every process it
    starts inherits it), the arrays are saved there once and read back by
    the other processes."""
    from ps_pytorch_tpu_torch.data import datasets

    root = os.environ.get(ARRAYS_ENV)
    made, make = {}, datasets._synthetic

    def once(name, train, seed=0):
        key = (name, bool(train), int(seed))
        if key not in made:
            arrays = tuple(np.load(p) for p in saved_arrays(
                make, root, *key)) if root else make(*key)
            for a in arrays:
                a.flags.writeable = False
            made[key] = arrays
        return made[key]

    datasets._synthetic = once
    try:
        yield
    finally:
        datasets._synthetic = make


@contextmanager
def flops_counted_once():
    """Inside: each configuration's model FLOPs a step (``runtime/
    ops_plane.py``'s ``step_flops_of``: the model run on the ``meta``
    device under a dispatch mode, whose first use in a process imports
    ``torch._dynamo``, about 2 s) are counted once for the script and its
    ranks, keyed by what the count reads; where $CHIP_SMOKE_ARRAYS names a
    directory they are saved there as JSON and read back by the other
    processes. The count is a function of its key, so every reader gets
    the number it would have counted."""
    import hashlib

    from ps_pytorch_tpu_torch.runtime import ops_plane

    root = os.environ.get(ARRAYS_ENV)
    count, made = ops_plane.step_flops_of, {}

    def once(cfg, batch=None, groups=1):
        key = json.dumps([cfg.network, cfg.dataset, cfg.num_classes,
                          cfg.batch_size if batch is None else batch,
                          cfg.lm_vocab, cfg.lm_d_model, cfg.lm_layers,
                          cfg.lm_heads, cfg.lm_seq_len, cfg.lm_experts,
                          cfg.lm_moe_top_k, groups])
        if key not in made:
            path = root and Path(root, "flops-" + hashlib.sha256(
                key.encode()).hexdigest()[:16] + ".json")
            if path and path.exists():
                made[key] = json.loads(path.read_text())
            else:
                made[key] = count(cfg, batch, groups)
                if path:
                    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
                    tmp.write_text(json.dumps(made[key]))
                    os.replace(tmp, path)
        return made[key]

    ops_plane.step_flops_of = once
    try:
        yield
    finally:
        ops_plane.step_flops_of = count


def run_train(argv):
    """``train.run(argv)`` with its output echoed: (trainer, text)."""
    from ps_pytorch_tpu_torch import train

    out = io.StringIO()
    with redirect_stdout(out):
        trainer, _ = train.run(argv)
    for line in out.getvalue().splitlines():
        print(line if len(line) < 400 else line[:200] + " ...", flush=True)
    return trainer, out.getvalue()


def state_of(trainer) -> dict:
    return {k: v.detach().clone() for k, v in
            trainer.model.state_dict().items()}


def crash_main_path(torch, wrappers) -> dict:
    """MAIN-CRASH: the CNN path's ResNet-18 through ``train.main`` in this
    process with ``--fault-spec`` (a crash at step 5, the step-6
    checkpoint corrupted after its commit, 5% KV drops) and
    ``--auto-resume 2 --eval-freq 2 --ckpt-keep 3``: the crash prints
    CRASH and the run resumes from step 4; a second run to step 8 walks
    past the corrupt step 6 to step 4 and ends bitwise where an
    uninterrupted 8-step run ends (the JAX package's RESILIENCE_r07
    scenario); in the first run's JSONL each trainer's retries add up to
    the injected drops, with no give-up. Then SIGTERM, sent to a run of
    its own once its second step is logged, makes it commit an emergency
    checkpoint at the next step boundary and leave."""
    import os
    import signal

    from ps_pytorch_tpu_torch.runtime import checkpoint as ckpt
    from ps_pytorch_tpu_torch.tools.profile_capture import card_line

    root = tempfile.mkdtemp(prefix="chip_smoke_crash_")
    chaos = f"{root}/chaos"
    card = card_line()
    try:
        zero_counts(wrappers)
        t0 = time.monotonic()
        _, text = run_train([*CRASH_ARGS, "--max-steps", "6", "--train-dir",
                             chaos, "--resume", "false", "--auto-resume",
                             "2", "--fault-spec", CRASH_SPEC,
                             "--metrics-file", f"{root}/chaos.jsonl"])
        crash_s = time.monotonic() - t0
        launches = read_counts(wrappers)
        # Steps 1-4, the crash, 5-6 again from 4: 6 steps, and the final
        # evaluation's 2 batches.
        want = want_counts(wrappers, conv3x3=CONV_PER_STEP * 6
                           + CONV_PER_EVAL_BATCH * 2, fused_sgd=6)
        if launches != want:
            fail(f"MAIN-CRASH launches {launches}, expected {want}")
        if "CRASH InjectedCrash: injected replica_crash r=0 at step 5" \
                not in text or \
                f"RESUME from {chaos}/model_step_4 at step 4" not in text:
            fail("MAIN-CRASH: no CRASH line, or no resume from step 4")
        if ckpt.committed_steps(chaos) != [2, 4, 6] or \
                ckpt.latest_valid_step(chaos) != 4:
            fail(f"MAIN-CRASH: committed {ckpt.committed_steps(chaos)}, "
                 f"newest valid {ckpt.latest_valid_step(chaos)}: expected "
                 "[2, 4, 6] with step 6 corrupt")
        rows = read_jsonl(f"{root}/chaos.jsonl")
        runs = list({r["crashes"]: r for r in rows}.values())
        retries = sum(r["kv_retries"] for r in runs)
        if [r["crashes"] for r in runs] != [0, 1] or \
                retries != runs[-1]["kv_drops"] or runs[-1]["kv_giveups"]:
            fail(f"MAIN-CRASH: retries {retries} against drops "
                 f"{runs[-1]['kv_drops']}, giveups {runs[-1]['kv_giveups']}"
                 f" (trainers {[r['crashes'] for r in runs]})")
        resumed, text = run_train([*CRASH_ARGS, "--max-steps", "8",
                                   "--train-dir", chaos, "--fault-spec",
                                   "kv_drop:p=0.05,seed=7"])
        if "[ckpt] step 6 failed verification" not in text or \
                f"RESUME from {chaos}/model_step_4 at step 4" not in text:
            fail("MAIN-CRASH: the resumed run did not walk past the "
                 "corrupt step 6 to step 4")
        plain, _ = run_train([*CRASH_ARGS, "--max-steps", "8",
                              "--train-dir", f"{root}/plain", "--resume",
                              "false"])
        got, ref = state_of(resumed), state_of(plain)
        diff = max(float((got[k].float() - ref[k].float()).abs().max())
                   for k in ref)
        if diff != 0.0:
            fail(f"MAIN-CRASH: the resumed run ends {diff} from the "
                 "uninterrupted one, not bitwise")
        del resumed, plain
        print(f"MAIN-CRASH crash run {crash_s:.2f} s (crash at 5, resume "
              f"from 4, step 6 corrupted); kv_drops "
              f"{runs[-1]['kv_drops']} kv_retries {retries} (trainers "
              f"{[r['kv_retries'] for r in runs]}) kv_giveups 0; the run "
              f"resumed to step 8 past the corrupt step 6 ends bitwise "
              f"where the uninterrupted 8-step run ends (max abs diff "
              f"{diff:.1e}); launches {launches} card {card}", flush=True)
        # SIGTERM to a run of its own, once its second step is logged.
        rows_path = f"{root}/sigterm.jsonl"
        sent = threading.Event()

        def send():
            deadline = time.monotonic() + 120
            while time.monotonic() < deadline:
                if Path(rows_path).exists() and \
                        len(Path(rows_path).read_text().splitlines()) >= 2:
                    os.kill(os.getpid(), signal.SIGTERM)
                    sent.set()
                    return
                time.sleep(0.02)

        sender = threading.Thread(target=send, daemon=True)
        sender.start()
        _, text = run_train([*CRASH_ARGS, "--max-steps", "200",
                             "--eval-freq", "0", "--train-dir",
                             f"{root}/sigterm", "--resume", "false",
                             "--metrics-file", rows_path])
        sender.join()
        found = re.findall(r"^PREEMPT emergency checkpoint at step (\d+)$",
                           text, re.M)
        if not sent.is_set() or len(found) != 1 or \
                ckpt.latest_valid_step(f"{root}/sigterm") != int(found[0]):
            fail(f"MAIN-CRASH: SIGTERM sent {sent.is_set()}, PREEMPT "
                 f"{found}, newest valid "
                 f"{ckpt.latest_valid_step(f'{root}/sigterm')}")
        print(f"MAIN-CRASH SIGTERM sent once 2 steps were logged: "
              f"emergency checkpoint at step {found[0]}, verified; card "
              f"{card}", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


def memory_main_path(torch) -> dict:
    """MEMORY: the port's ``tools/memory_probe`` through its ``main`` at
    the JAX geometry, ``MEMORY_MODES`` each in a child process of its own,
    ``MEMORY_JOBS`` at once (each peak is its own process's; the children
    count their own launches). Fails on a row with an error, on lm_remat
    or lm_flash not peaking below lm_base, and on lm_flash's flash
    launches other than 3 steps x 8 layers of each kernel, all on the
    tensor cores. Prints each row and the artifact's deltas; returns
    lm_flash's launches."""
    from ps_pytorch_tpu_torch.tools import memory_probe
    from ps_pytorch_tpu_torch.tools.profile_capture import card_line

    root = tempfile.mkdtemp(prefix="chip_smoke_memory_")
    try:
        torch.cuda.empty_cache()
        out = f"{root}/memory.json"
        with redirect_stdout(io.StringIO()):
            memory_probe.main(["--modes", ",".join(MEMORY_MODES), "--jobs",
                               str(MEMORY_JOBS), "--out", out, "--timeout",
                               "300"])
        doc = json.loads(Path(out).read_text())
    finally:
        shutil.rmtree(root, ignore_errors=True)
    rows = {r["mode"]: r for r in doc["rows"]}
    for mode in MEMORY_MODES:
        row = rows.get(mode, {"error": "no row"})
        if "error" in row:
            fail(f"MEMORY {mode}: {row['error']}")
        print(f"MEMORY {mode} peak_bytes_in_use {row['peak_bytes_in_use']} "
              f"bytes_in_use {row['bytes_in_use']} loss {row['loss']} "
              f"step_s {row['step_s']} wall_s {row['wall_s']} on "
              f"{row['device_kind']}", flush=True)
    peak = {m: rows[m]["peak_bytes_in_use"] for m in MEMORY_MODES}
    for mode in ("lm_remat", "lm_flash"):
        if not peak[mode] < peak["lm_base"]:
            fail(f"MEMORY {mode} peaks at {peak[mode]} B, not below "
                 f"lm_base's {peak['lm_base']} B")
    layers = memory_probe.LM_GEOM["n_layers"]
    launches = rows["lm_flash"]["flash_launches"]
    want = {k: MEMORY_STEPS * layers for k in launches}
    if set(launches) != {f"{k}{tc}" for k in ("flash_fwd", "flash_dq",
                                                "flash_dkv")
                         for tc in ("", "_tc")} or launches != want:
        fail(f"MEMORY lm_flash launches {launches}, expected {want}")
    print(f"MEMORY deltas {json.dumps(doc['deltas'])} complete "
          f"{doc['complete']}; card {card_line()}", flush=True)
    return launches


def cache_bytecode() -> None:
    """Compile Python sources once for all the processes this script
    starts. Where the environment says not to write bytecode
    (``PYTHONDONTWRITEBYTECODE``), every rank and server process would
    compile torch's sources anew, seconds of each start. The bytecode goes
    under the package's build directory, beside the kernels; the processes
    started later inherit the setting through the environment."""
    pkg = Path(__file__).resolve().parent / "ps_pytorch_tpu_torch"
    if not pkg.is_dir():
        return
    prefix = str(pkg / "build" / "pycache")
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ["PYTHONPYCACHEPREFIX"] = prefix
    sys.dont_write_bytecode = False
    sys.pycache_prefix = prefix


RANK_MODES = {"--rank": rank_main, "--rank-wire": wire_rank_main,
              "--rank-elect": elect_rank_main,
              "--rank-shard": shard_rank_main,
              "--rank-poison": poison_rank_main,
              "--rank-hier": hier_rank_main,
              "--rank-lmdist": lmdist_rank_main}


def main() -> int:
    rank_mode = RANK_MODES.get(sys.argv[1] if len(sys.argv) > 1 else "")
    if rank_mode is not None:
        with arrays_made_once(), flops_counted_once():
            return rank_mode(sys.argv[2:])
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs "
             "an NVIDIA card")
    cache_bytecode()
    import torch.nn.functional as F
    from ps_pytorch_tpu_torch.models import build_model
    from ps_pytorch_tpu_torch.ops import _build
    from ps_pytorch_tpu_torch.ops import conv3x3 as conv_mod
    from ps_pytorch_tpu_torch.ops import flash_attention as fa
    from ps_pytorch_tpu_torch.ops import fused_adam as adam_mod
    from ps_pytorch_tpu_torch.ops import fused_sgd as sgd_mod
    from ps_pytorch_tpu_torch.ops import quantize as tq
    from ps_pytorch_tpu_torch.tools.profile_capture import card_line

    card = card_line()
    print(f"CARD {card}", flush=True)
    print(f"TORCH {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}", flush=True)
    # References in full f32: neither cuBLAS nor cuDNN may use TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # The RRC loader's g++ build runs beside the nvcc builds, and this
    # process makes the synthetic sets of the phases meanwhile (the
    # compilers are processes of their own): once for the whole script,
    # its ranks included (arrays_made_once).
    from ps_pytorch_tpu_torch.data import augment, datasets
    arrays_dir = tempfile.mkdtemp(prefix="chip_smoke_arrays_")
    atexit.register(shutil.rmtree, arrays_dir, True)
    os.environ[ARRAYS_ENV] = arrays_dir
    rrc, nvcc = {}, {}
    t0 = time.monotonic()

    def kernels_built():
        try:
            nvcc["took"] = _build.build()
        except Exception as e:  # raised in this thread after the join
            nvcc["error"] = e
        nvcc["s"] = time.monotonic() - t0

    builds = [threading.Thread(target=lambda: rrc.update(
        backend=augment.rrc_backend(), s=time.monotonic() - t0)),
        threading.Thread(target=kernels_built)]
    for thread in builds:
        thread.start()
    with ThreadPoolExecutor(4) as pool:    # numpy draws without the GIL
        list(pool.map(lambda key: saved_arrays(
            datasets._synthetic, arrays_dir, *key), PHASE_ARRAYS))
    for thread in builds:
        thread.join()
    if "error" in nvcc:
        raise nvcc["error"]
    took = nvcc["took"]
    print(f"BUILD nvcc {took} wall {nvcc['s']:.2f} s", flush=True)
    if rrc["backend"] != "native":
        fail("the native RRC loader (native/loader.cpp) did not build")
    print(f"BUILD g++ RRC loader {rrc['s']:.2f} s "
          f"{Path(augment._load_native_loader()._name).name}", flush=True)
    for name in took:
        kernel = ""
        for line in _build.build_log(name).splitlines():
            if "Compiling entry function" in line:
                kernel = kernel_name(line)
            elif "registers" in line or "spill" in line or "error" in line:
                print(f"PTXAS {name} {kernel}: {line.strip()}", flush=True)
    t0 = time.monotonic()
    one = torch.ones(4, device="cuda")
    sgd_mod.fused_sgd_update(one.clone(), one.clone(), one.clone(), 0.1, True,
                             momentum=0.9, dampening=0.0, weight_decay=0.0,
                             nesterov=False)
    torch.cuda.synchronize()
    print(f"BUILD triton fused_sgd {time.monotonic() - t0:.2f} s", flush=True)
    t0 = time.monotonic()
    adam_mod.fused_adam_update(one.clone(), one.clone(), one.clone(), None,
                               one.clone(), 0.1, b1=0.9, b2=0.999, eps=1e-8,
                               weight_decay=0.0)
    torch.cuda.synchronize()
    print(f"BUILD triton fused_adam {time.monotonic() - t0:.2f} s",
          flush=True)

    wrappers = kernel_wrappers()
    t_start = time.monotonic()

    def timed(fn, *args):
        """``fn(*args)``, then a TIME line: its seconds, and the script's
        so far past the builds (the budget of each phase)."""
        t0 = time.monotonic()
        out = fn(*args)
        print(f"TIME {fn.__name__} {time.monotonic() - t0:.1f} s (at "
              f"{time.monotonic() - t_start:.1f} s)", flush=True)
        return out

    # Each path right after the checks of its own kernels, with the
    # allocator's cache emptied between the two: the ResNet steps ran
    # slower when they came after the flash checks.
    with arrays_made_once(), flops_counted_once():
        conv = timed(check_conv, torch, F, conv_mod)
        timed(time_weight_grad, torch, conv_mod)
        print(f"MEMORY allocated after the conv checks "
              f"{torch.cuda.memory_allocated()}", flush=True)
        leaf_sizes = [p.numel()
                      for p in build_model("ResNet18").parameters()]
        n_params = sum(leaf_sizes)
        sgd = timed(check_sgd, torch, sgd_mod, n_params)
        launches = timed(main_path, torch, wrappers)
        timed(telemetry_main_path, torch, wrappers,
              launches["median_step_s"])
        timed(health_on_card, torch)
        timed(small_step_agrees, torch, conv_mod, "float32")
        timed(small_step_agrees, torch, conv_mod, "bfloat16")
        timed(small_step_agrees, torch, conv_mod, "float16")
        f16_launches = timed(f16_main_path, torch, wrappers,
                             launches["median_step_s"])
        quant = timed(check_quantize, torch, tq, leaf_sizes)
        async_launches = timed(async_main_path, torch, wrappers, n_params)
        timed(small_async_tick_agrees, torch, tq)
        adam = timed(check_adam, torch, adam_mod, n_params)
        slices = timed(check_zero_slices, torch, sgd_mod, adam_mod,
                       n_params)
        ckpt_launches = timed(ckpt_main_path, torch, wrappers)
        crash_launches = timed(crash_main_path, torch, wrappers)
        torch.cuda.empty_cache()
        vgg_conv = timed(check_conv_geometries, torch, F, conv_mod,
                         "VGG11", BATCH, VGG_GEOMETRIES)
        vgg_conv16 = timed(check_conv_geometries, torch, F, conv_mod,
                           "VGG11", BATCH, VGG_GEOMETRIES, "float16")
        vgg_launches = timed(vgg_main_path, torch, wrappers)
        timed(small_vgg_and_stem_steps_agree, torch, conv_mod)
        r50_conv = timed(check_conv_geometries, torch, F, conv_mod,
                         "ResNet50_ImageNet", IMAGENET_BATCH,
                         RESNET50_GEOMETRIES)
        r50_conv16 = timed(check_conv_geometries, torch, F, conv_mod,
                           "ResNet50_ImageNet", IMAGENET_BATCH,
                           RESNET50_GEOMETRIES, "float16")
        imagenet_launches = timed(imagenet_main_path, torch, wrappers)
        torch.cuda.empty_cache()
        timed(dist_main_path, wrappers)
        timed(kofn_main_path, wrappers)
        zero_launches = timed(zero_main_path, wrappers, n_params)
        timed(wire_int8_bytes_agree, torch, tq)
        wire_launches = timed(wire_main_path, wrappers)
        elect_launches = timed(elect_main_path, wrappers)
        timed(check_zero_wire, torch)
        shard_launches = timed(shard_main_path, wrappers)
        shard_slices = timed(shard_slices_leg, torch, wrappers)
        timed(check_integrity_on_device, torch)
        poison_launches = timed(poison_main_path, wrappers)
        timed(check_hier, torch)
        hier_launches = timed(hier_main_path, wrappers)
        hier_slices = timed(hier_slices_leg, torch, wrappers)
        kvrep_launches = timed(kvrep_main_path, wrappers)
        flash = timed(check_flash, torch, F, fa)
        torch.cuda.empty_cache()
        lm_launches = timed(lm_main_path, torch, wrappers)
        timed(small_lm_step_agrees, torch, fa)
        torch.cuda.empty_cache()
        lm8k = timed(lm8k_main_path, torch, F, fa, wrappers)
        torch.cuda.empty_cache()
        lmckpt = timed(lm_ckpt_main_path, torch, wrappers)
        torch.cuda.empty_cache()
        memory = timed(memory_main_path, torch)
        lmdist = timed(lmdist_main_path, torch, wrappers)
        torch.cuda.empty_cache()
        served = timed(serve_main_path, torch, wrappers,
                       lmckpt["served_dir"])
        # ACCURACY digits' two processes (LeNet on the card) run beside
        # ACCURACY-LM in this one: neither reads the other's launches or
        # times, and the script's budget gains the digits' ~24 s.
        with ThreadPoolExecutor(1) as beside:
            digits = beside.submit(timed, digits_accuracy, torch)
            acc_lm = timed(accuracy_lm, torch, wrappers)
            digits.result()

    kernels = [
        dict(name="conv3x3", route="cuda",
             source="ps_pytorch_tpu_torch/csrc/conv3x3.cu",
             replaces="ps_pytorch_tpu/ops/pallas_conv.py:43",
             launches=launches["conv3x3"],
             tc_launches=launches["conv3x3_tc"],
             max_abs_err=conv["max_abs_err"],
             ms=conv["ms"], plain_ms=conv["plain_ms"],
             bound_ms=conv["bound_ms"],
             bound_by=("operations" if conv["ops_ms"] >= conv["bytes_ms"]
                       else "bytes"),
             library_ms=conv["library_ms"],
             # f16 (tc): MAIN-F16's launches, all of them, by run; one
             # step's 26 at MAIN's geometry and the other models' steps.
             float16=dict(
                 launches=f16_launches["conv3x3"],
                 tc_launches=f16_launches["conv3x3_tc"],
                 launches_by_run={run: c["conv3x3"] for run, c
                                  in f16_launches["by_run"].items()},
                 **{key: conv["float16"][key] for key in (
                     "ms", "simt_ms", "plain_ms", "library_ms", "bound_ms",
                     "max_abs_err")},
                 bound_by=("operations" if conv["float16"]["ops_ms"]
                           >= conv["float16"]["bytes_ms"] else "bytes"),
                 paths={name: {key: timed[key] for key in (
                     "ms", "bound_ms", "plain_ms", "library_ms",
                     "max_abs_err", "launches_a_step")}
                     for name, timed in (("VGG11", vgg_conv16),
                                         ("ResNet50_ImageNet", r50_conv16))}),
             # The slice's other paths: launches of each run, and one
             # train step's launches at its geometries (kernel, bound,
             # plain version and F.conv2d, ms).
             paths={
                 name: dict(launches=counts["conv3x3"],
                            tc_launches=counts["conv3x3_tc"],
                            step_ms=timed["ms"], bound_ms=timed["bound_ms"],
                            plain_ms=timed["plain_ms"],
                            library_ms=timed["library_ms"],
                            max_abs_err=timed["max_abs_err"])
                 for name, counts, timed in (
                     ("MAIN-VGG", vgg_launches, vgg_conv),
                     ("MAIN-IMAGENET", imagenet_launches, r50_conv))},
             # MAIN-WIRE, MAIN-ZERO (a rank, each run; remat adds the 13
             # forwards a step) and MAIN-CRASH run MAIN's geometry: their
             # times are this row's.
             launches_by_path={
                 "MAIN-WIRE": wire_launches["conv3x3"],
                 "MAIN-ELECT": elect_launches["conv3x3"],
                 "MAIN-SHARD": shard_launches["conv3x3"],
                 "MAIN-SHARD slices": shard_slices["conv3x3"],
                 "MAIN-POISON": poison_launches["conv3x3"],
                 "MAIN-HIER": hier_launches["conv3x3"],
                 "MAIN-HIER slices": hier_slices["conv3x3"],
                 "MAIN-KVREP": kvrep_launches["conv3x3"],
                 "MAIN-ZERO shard-update": zero_launches["shard-update"][
                     "conv3x3"],
                 "MAIN-ZERO replicated": zero_launches["replicated"][
                     "conv3x3"],
                 "MAIN-CRASH": crash_launches["conv3x3"]},
             tc_launches_by_path={
                 "MAIN-WIRE": wire_launches["conv3x3_tc"],
                 "MAIN-ELECT": elect_launches["conv3x3_tc"],
                 "MAIN-SHARD": shard_launches["conv3x3_tc"],
                 "MAIN-SHARD slices": shard_slices["conv3x3_tc"],
                 "MAIN-POISON": poison_launches["conv3x3_tc"],
                 "MAIN-HIER": hier_launches["conv3x3_tc"],
                 "MAIN-HIER slices": hier_slices["conv3x3_tc"],
                 "MAIN-KVREP": kvrep_launches["conv3x3_tc"],
                 "MAIN-ZERO shard-update": zero_launches["shard-update"][
                     "conv3x3_tc"],
                 "MAIN-ZERO replicated": zero_launches["replicated"][
                     "conv3x3_tc"],
                 "MAIN-CRASH": crash_launches["conv3x3_tc"]}),
        dict(name="fused_sgd", route="triton",
             source="ps_pytorch_tpu_torch/ops/_sgd_triton.py",
             replaces="ps_pytorch_tpu/ops/fused_sgd.py:34",
             launches=launches["fused_sgd"],
             launches_by_path={"MAIN-VGG": vgg_launches["fused_sgd"],
                               "MAIN-F16": f16_launches["fused_sgd"],
                               "MAIN-IMAGENET":
                               imagenet_launches["fused_sgd"],
                               "MAIN-WIRE": wire_launches["fused_sgd"],
                               "MAIN-ELECT (the promoted process)":
                               elect_launches["fused_sgd"],
                               "MAIN-SHARD (the update on the host)":
                               shard_launches["fused_sgd"],
                               "MAIN-SHARD slices (the update on the host)":
                               shard_slices["fused_sgd"],
                               "MAIN-POISON (the leader)":
                               poison_launches["fused_sgd"],
                               "MAIN-HIER (the root's applied updates)":
                               hier_launches["fused_sgd"],
                               "MAIN-HIER slices": hier_slices["fused_sgd"],
                               "MAIN-KVREP": kvrep_launches["fused_sgd"],
                               "MAIN-ZERO shard-update (on a rank's slice)":
                               zero_launches["shard-update"]["fused_sgd"],
                               "MAIN-ZERO replicated":
                               zero_launches["replicated"]["fused_sgd"],
                               "MAIN-CRASH": crash_launches["fused_sgd"]},
             max_abs_err=sgd["max_abs_err"],
             slices_max_abs_err=slices["max_abs_err"],
             ms=sgd["ms"], plain_ms=sgd["plain_ms"], bound_ms=sgd["bound_ms"],
             bound_by="bytes", library_ms=sgd["library_ms"]),
        dict(name="fused_adam", route="triton",
             source="ps_pytorch_tpu_torch/ops/_adam_triton.py",
             replaces="ps_pytorch_tpu/ops/fused_adam.py:31",
             launches=ckpt_launches["fused_adam"],
             max_abs_err=adam["max_abs_err"], ms=adam["ms"],
             plain_ms=adam["plain_ms"], bound_ms=adam["bound_ms"],
             bound_by="bytes", library_ms=adam["library_ms"]),
        dict(name="quantize", route="cuda",
             source="ps_pytorch_tpu_torch/csrc/quantize.cu",
             replaces="ps_pytorch_tpu/ops/quantize.py:45",
             launches=async_launches["quantize"],
             launches_by_path={"MAIN-WIRE": wire_launches["quantize"],
                               "MAIN-ELECT": elect_launches["quantize"]},
             **quant, bound_by="bytes", library_ms=None),
    ] + [
        dict(name=name, route="cuda",
             source="ps_pytorch_tpu_torch/csrc/flash_attention.cu",
             replaces=f"ps_pytorch_tpu/ops/flash_attention.py:{line}",
             launches=lm_launches[name],
             **dict(flash[name], float16=dict(
                 flash[name]["float16"], launches=f16_launches[name],
                 note="op level only: no trainer computes attention in "
                      "f16 (MAIN-F16 launches none)")),
             # MAIN-LM8K's [1, 8, 8192, 64] f32 causal: its figures and
             # its training run's launches (3 steps and FINAL's 8 eval
             # batches; the evaluator's flash oracle in flash_oracle).
             s8192=dict({key: lm8k["figures"][name][key] for key in (
                 "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                 "bound_tc_ms", "max_abs_err")},
                 launches=lm8k["launches"][name],
                 tc_launches=lm8k["launches"][f"{name}_tc"],
                 flash_oracle=lm8k["oracle_launches"][name]),
             **({"tc_launches": lm_launches[f"{name}_tc"]}
                if f"{name}_tc" in lm_launches else {}),
             # MAIN-LMCKPT (remat: the forward again in the backward) a
             # run, and ACCURACY-LM at its [16, 4, 256, 32].
             launches_by_path={
                 "MAIN-LMCKPT run": lmckpt[name],
                 "MAIN-LMCKPT resumed": lmckpt["resumed"][name],
                 "ACCURACY-LM": acc_lm[name],
                 "MAIN-SERVE (decode: full attention)": served[name],
                 "MAIN-LMCKPT evaluate (flash oracle)":
                 lmckpt["evaluate"][name],
                 "MAIN-LM8K (3 steps and FINAL)": lm8k["launches"][name],
                 "MAIN-LMDIST pp (a rank, 3 steps and FINAL)":
                 lmdist["pp"][name],
                 "MAIN-LMDIST sp (a rank; ring)": lmdist["sp"][name],
                 "MAIN-LMDIST tp (a rank, FINAL's flash oracle)":
                 lmdist["tp"][name],
                 "MAIN-LMDIST tp7 (a rank, FINAL's flash oracle)":
                 lmdist["tp7"][name],
                 "MAIN-LMDIST sp's checkpoint, evaluate.main in one "
                 "process": lmdist["sp_oracle"][name],
                 "MAIN-MOE (a rank, 3 steps and FINAL)":
                 lmdist["ep"][name],
                 "MEMORY lm_flash (a child process, 3 steps)":
                 memory[name]},
             tc_launches_by_path={
                 "MAIN-LMCKPT run": lmckpt[f"{name}_tc"],
                 "MAIN-LMCKPT resumed": lmckpt["resumed"][f"{name}_tc"],
                 "ACCURACY-LM": acc_lm[f"{name}_tc"],
                 "MAIN-LM8K (3 steps and FINAL)":
                 lm8k["launches"][f"{name}_tc"],
                 "MAIN-LMDIST pp (a rank, 3 steps and FINAL)":
                 lmdist["pp"][f"{name}_tc"],
                 "MAIN-MOE (a rank, 3 steps and FINAL)":
                 lmdist["ep"][f"{name}_tc"],
                 "MEMORY lm_flash (a child process, 3 steps)":
                 memory[f"{name}_tc"]})
        for name, line in (("flash_fwd", 95), ("flash_dq", 164),
                           ("flash_dkv", 189))
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"CARD {card_line()}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
