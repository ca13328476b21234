"""The LM training loop: the JAX package's ``runtime/lm_trainer.py``
(build ``:54-103, 193-197``, checkpoint and resume ``:279-358``, ``train``
``:359-443``, ``evaluate`` ``:479-500``) for ``lm_parallelism="sp"`` on one
device.

On one device the sequence is not sharded, so ``--lm-attention auto``
resolves to ``full`` (as the JAX trainer does there) and ``flash`` to the
hand-written kernels. The optimizer is the plain ``optim.SGD`` with the
configured schedule whatever ``--fused-optimizer`` says, as
``lm_trainer.py:59-63``. STEP lines carry ``acc 0.0 participating 1.0``
(``:403-407``); the JSONL record adds ``tokens_per_sec``. ``--remat``
recomputes each block in the backward (``models/transformer.py``).

``step_time`` runs from fetching the batch to reading the step's loss when
the step is logged, which waits for the device; an unlogged step's time
ends at dispatch.

Checkpoints are the JAX LM's: the ``TrainState`` (step, params, the SGD
state, ``batch_stats={}``) in the JAX layout (``models/convert.py``), with
the config (``network`` resolved), under ``--compress-grad``'s container
and ``--ckpt-keep``; written every ``eval_freq`` steps, at the last step
and at a health halt. ``train`` resumes from the newest checkpoint that
verifies, walking back past corrupt ones, refuses one of another geometry
with the JAX message, and prints ``RESUME lm at step k``. As in the JAX
package the token loader is not fast-forwarded: a resumed run draws its
batches from the start of the stream. The fault plane fires
``replica_crash`` at the top of a step and ``ckpt_corrupt`` after a
commit.

The ops plane is the CNN Trainer's (``runtime/ops_plane.py``), as the JAX
LM trainer's is: spans ``data_wait``, ``host_dispatch``,
``metrics_sync`` and ``checkpoint``, ``mfu`` counted from the
full-attention model whether ``--lm-attention`` is ``flash`` or ``full``,
the exporter (with the fault counters when a fault spec is set), the
watchdogs (on the loss the logged steps read: the LM step has no grad
norm, as in the JAX package), the flight recorder, the timeline and the
profiler window.
"""

import dataclasses
import json
import time
from typing import Optional

import numpy as np
import torch

from ps_pytorch_tpu_torch import resilience
from ps_pytorch_tpu_torch.config import TrainConfig
from ps_pytorch_tpu_torch.data.text import TokenLoader, lm_streams
from ps_pytorch_tpu_torch.models.convert import state_to_jax
from ps_pytorch_tpu_torch.models.transformer import TransformerLM
from ps_pytorch_tpu_torch.optim import SGD, build_schedule
from ps_pytorch_tpu_torch.parallel.sp import LMTrainStep, make_lm_eval_fn
from ps_pytorch_tpu_torch.runtime import checkpoint as ckpt
from ps_pytorch_tpu_torch.runtime.coordinator import KVStore
from ps_pytorch_tpu_torch.runtime.lm_eval import restore_lm
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
        # The network the LM trains, as the JAX LM trainer resolves it
        # (``lm_trainer.py:171-175``): the FLOP count reads it, and the
        # checkpoint's config records it.
        self.cfg = cfg = dataclasses.replace(cfg, network="TransformerLM")
        impl = "flash" if cfg.lm_attention == "flash" else "full"
        self.model = TransformerLM(
            vocab_size=cfg.lm_vocab, n_layers=cfg.lm_layers,
            n_heads=cfg.lm_heads, d_model=cfg.lm_d_model,
            max_seq_len=cfg.lm_seq_len, attention_impl=impl,
            generator=torch.Generator().manual_seed(cfg.seed),
            remat=cfg.remat).to(self.device)
        self.opt = SGD(lr=build_schedule(cfg), momentum=cfg.momentum,
                       weight_decay=cfg.weight_decay, nesterov=cfg.nesterov)
        self.step_fn = LMTrainStep(self.model, self.opt)
        self.eval_fn = make_lm_eval_fn(self.model)
        train_stream, self.val_tokens = lm_streams(cfg)
        self.train_loader = TokenLoader(train_stream, cfg.batch_size,
                                        cfg.lm_seq_len, seed=cfg.seed)
        self.metrics = MetricsLogger(cfg.metrics_file, cfg.log_every,
                                     printer=printer)
        # Fault plane: step-keyed crashes and the corruption of a
        # committed checkpoint, for resilience drills.
        self.injector = (resilience.FaultInjector(cfg.fault_spec)
                         if cfg.fault_spec else None)
        self.ops = OpsPlane(cfg, device=self.device, rank=0, world=1,
                            kv=KVStore(), health_extra=lambda: {
                                "leader": True, "role": "leader"},
                            resilience=(self.injector.snapshot
                                        if self.injector else None),
                            printer=printer)
        self.printer = printer
        self.step_times: list = []
        self.start_step = 0

    # ---- checkpoint and resume (the CNN Trainer's layout) ----
    def checkpoint(self, step: int) -> str:
        """Commit ``model_step_<step>``, let a ``ckpt_corrupt`` fault
        strike it, then keep the newest ``ckpt_keep`` when that is set."""
        cfg = self.cfg
        path = ckpt.save_checkpoint(
            cfg.train_dir, step,
            state_to_jax(self.model, self.step_fn.opt_state, step),
            config_json=cfg.to_json(), compress=cfg.compress_grad,
            codec_level=cfg.codec_level)
        if self.injector is not None:
            # After the atomic commit: the torn artifact the manifest
            # check must catch, not a failed write.
            self.injector.after_checkpoint(cfg.train_dir, step)
        if cfg.ckpt_keep > 0:
            ckpt.prune_checkpoints(cfg.train_dir, cfg.ckpt_keep)
        return path

    def maybe_resume(self) -> bool:
        """Restore the newest checkpoint that verifies (a layout from
        before the q/k/v split migrates on load); a checkpoint of another
        model, or of another LM geometry, raises."""
        cfg = self.cfg
        if ckpt.latest_step(cfg.train_dir) is None:
            return False

        def unrestorable(e: Exception) -> ValueError:
            # Most likely a CNN checkpoint sharing the train_dir.
            return ValueError(
                f"could not restore a checkpoint from {cfg.train_dir} "
                f"into the LM state (a train.py checkpoint in the same "
                f"train_dir? use a separate --train-dir or "
                f"--no-resume): {type(e).__name__}: {e}")

        try:
            got = ckpt.load_latest_valid(cfg.train_dir)
        except Exception as e:
            raise unrestorable(e) from e
        if got is None:
            return False
        tree, meta, config_json, step = got
        try:
            saved = json.loads(config_json)
        except (TypeError, ValueError):
            saved = {}
        for k in ("lm_vocab", "lm_d_model", "lm_layers", "lm_heads",
                  "lm_parallelism", "lm_experts", "lm_model_axis",
                  "lm_moe_top_k"):
            if k == "lm_model_axis" and saved.get(k) == 0:
                continue
            if k in saved and saved[k] != getattr(cfg, k):
                raise ValueError(
                    f"checkpoint in {cfg.train_dir} was written with "
                    f"{k}={saved[k]} but this run uses "
                    f"{getattr(cfg, k)} — wrong train_dir, or pass "
                    f"--no-resume / a fresh --train-dir")
        try:
            self.step_fn.opt_state, _ = restore_lm(
                tree, self.model, self.step_fn.opt_state, step=step)
        except Exception as e:
            raise unrestorable(e) from e
        self.start_step = int(meta["step"])
        self.printer(f"RESUME lm at step {self.start_step}")
        return True

    def train(self) -> None:
        cfg = self.cfg
        ops, tracer = self.ops, self.ops.tracer
        tokens_a_step = cfg.batch_size * cfg.lm_seq_len
        if cfg.resume:
            self.maybe_resume()
        step = self.start_step
        halted = False
        try:
            while step < cfg.max_steps:
                step += 1
                if self.injector is not None:
                    self.injector.maybe_crash(step)
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
                    ops.halt(step, self.checkpoint)
                    halted = True
                    break
                if cfg.eval_freq > 0 and step % cfg.eval_freq == 0:
                    with tracer.span("checkpoint", step=step):
                        self.checkpoint(step)
                ops.publish_step(step, t_step, t_data)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            if not halted and cfg.eval_freq > 0 and \
                    step % cfg.eval_freq != 0:
                with tracer.span("checkpoint", step=step):
                    self.checkpoint(step)
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
