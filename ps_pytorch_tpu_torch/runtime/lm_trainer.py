"""The LM training loop: the core of the JAX package's
``runtime/lm_trainer.py`` (build ``:54-103``, ``train`` ``:359-443``,
``evaluate`` ``:479-500``) for ``lm_parallelism="sp"`` on one device.

On one device the sequence is not sharded, so ``--lm-attention auto``
resolves to ``full`` (as the JAX trainer does there) and ``flash`` to the
hand-written kernels. The optimizer is the plain ``optim.SGD`` with the
configured schedule whatever ``--fused-optimizer`` says, as
``lm_trainer.py:59-63``. STEP lines carry ``acc 0.0 participating 1.0``
(``:403-407``); the JSONL record adds ``tokens_per_sec``.

``step_time`` runs from fetching the batch to reading the step's loss when
the step is logged, which waits for the device; an unlogged step's time
ends at dispatch.

The ops plane is the CNN Trainer's (``runtime/ops_plane.py``), as the JAX
LM trainer's is: spans ``data_wait``, ``host_dispatch`` and
``metrics_sync``, ``mfu`` counted from the full-attention model whether
``--lm-attention`` is ``flash`` or ``full``, the exporter, the watchdogs
(on the loss the logged steps read: the LM step has no grad norm, as in
the JAX package), the flight recorder, the timeline and the profiler
window. A ``halt`` dumps the flight recorder and leaves the loop without
a checkpoint. LM checkpoints and resume, and the fault plane, are not
ported yet (ROADMAP.md): the trainer refuses ``eval_freq > 0`` and a
``train_dir`` to resume from.
"""

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ps_pytorch_tpu_torch.config import TrainConfig
from ps_pytorch_tpu_torch.data.text import TokenLoader, lm_streams
from ps_pytorch_tpu_torch.models.transformer import TransformerLM
from ps_pytorch_tpu_torch.optim import SGD, build_schedule
from ps_pytorch_tpu_torch.parallel.sp import LMTrainStep, make_lm_eval_fn
from ps_pytorch_tpu_torch.runtime.checkpoint import committed_steps
from ps_pytorch_tpu_torch.runtime.coordinator import KVStore
from ps_pytorch_tpu_torch.runtime.metrics import MetricsLogger
from ps_pytorch_tpu_torch.runtime.ops_plane import OpsPlane
from ps_pytorch_tpu_torch.runtime.trainer import (
    resolve_device, set_reference_numerics,
)


class LMTrainer:
    def __init__(self, cfg: TrainConfig, device: Optional[str] = None,
                 printer=print):
        set_reference_numerics()
        self.device = resolve_device(device)
        if cfg.eval_freq > 0 or (cfg.resume and
                                 committed_steps(cfg.train_dir)):
            raise ValueError(
                "LM checkpoints, and resuming from them, are not ported yet "
                "(ROADMAP.md); pass --eval-freq 0, and --resume false or "
                "another --train-dir")
        # The network the LM trains, as the JAX LM trainer resolves it
        # (``lm_trainer.py:171-175``): the FLOP count reads it.
        self.cfg = cfg = dataclasses.replace(cfg, network="TransformerLM")
        impl = "flash" if cfg.lm_attention == "flash" else "full"
        self.model = TransformerLM(
            vocab_size=cfg.lm_vocab, n_layers=cfg.lm_layers,
            n_heads=cfg.lm_heads, d_model=cfg.lm_d_model,
            max_seq_len=cfg.lm_seq_len, attention_impl=impl,
            generator=torch.Generator().manual_seed(cfg.seed)).to(self.device)
        self.opt = SGD(lr=build_schedule(cfg), momentum=cfg.momentum,
                       weight_decay=cfg.weight_decay, nesterov=cfg.nesterov)
        self.step_fn = LMTrainStep(self.model, self.opt)
        self.eval_fn = make_lm_eval_fn(self.model)
        train_stream, self.val_tokens = lm_streams(cfg)
        self.train_loader = TokenLoader(train_stream, cfg.batch_size,
                                        cfg.lm_seq_len, seed=cfg.seed)
        self.metrics = MetricsLogger(cfg.metrics_file, cfg.log_every,
                                     printer=printer)
        self.ops = OpsPlane(cfg, device=self.device, rank=0, world=1,
                            kv=KVStore(), health_extra=lambda: {
                                "leader": True, "role": "leader"},
                            printer=printer)
        self.step_times: list = []

    def train(self) -> None:
        cfg = self.cfg
        ops, tracer = self.ops, self.ops.tracer
        tokens_a_step = cfg.batch_size * cfg.lm_seq_len
        step = 0
        try:
            while step < cfg.max_steps:
                step += 1
                ops.count_flops()
                ops.profile_step(step)
                t0 = time.monotonic()
                with tracer.span("data_wait", step=step):
                    tokens = self.train_loader.next_batch()
                t_data = time.monotonic() - t0
                with tracer.span("host_dispatch", step=step):
                    m = self.step_fn(tokens)
                logged = step % cfg.log_every == 0 or step == cfg.max_steps
                loss = None
                if logged:
                    with tracer.span("metrics_sync", step=step):
                        loss = float(m["loss"])
                t_step = time.monotonic() - t0
                self.step_times.append(t_step)
                ops.ops_step(step, examples=cfg.batch_size, loss=loss,
                             step_time=t_step, data_time=t_data)
                if logged:
                    self.metrics.log_step(
                        step, self.train_loader._epoch, loss=loss, acc=0.0,
                        participating=1.0, step_time=t_step,
                        data_time=t_data, phases=tracer.step_summary(step),
                        **ops.derived(step_time=t_step, data_time=t_data,
                                      examples=cfg.batch_size,
                                      tokens=tokens_a_step))
                if ops.should_halt:
                    ops.halt(step, None)
                    break
                ops.publish_step(step, t_step, t_data)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        except BaseException as e:
            ops.crash(e)
            raise
        finally:
            self.metrics.close()
            ops.close(final_step=step)

    def evaluate(self, max_batches: Optional[int] = None) -> dict:
        """Held-out next-token loss and perplexity over the validation
        tail (its first ``max_batches`` batches), through the train step's
        forward."""
        cfg = self.cfg
        val = TokenLoader(self.val_tokens, cfg.batch_size, cfg.lm_seq_len,
                          seed=0, shuffle=False)
        losses = []
        for i, tokens in enumerate(val.epoch(0)):
            if max_batches is not None and i >= max_batches:
                break
            losses.append(float(self.eval_fn(tokens)))
        self.model.train()
        loss = float(np.mean(losses)) if losses else float("nan")
        return {"loss": loss, "perplexity": float(np.exp(min(loss, 30.0))),
                "batches": len(losses)}
