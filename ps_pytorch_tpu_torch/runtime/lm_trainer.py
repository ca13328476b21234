"""The LM training loop: the JAX package's ``runtime/lm_trainer.py``
(build ``:54-197``, checkpoint and resume ``:279-358``, ``train``
``:359-443``, ``evaluate`` ``:448-500``) over the ranks of a process group.

One JAX device of the LM mesh is one rank here (``parallel/mesh.py``). The
parallelism is ``--lm-parallelism``:

- ``sp``: the sequence sharded over every rank, attention a ring
  (``parallel/ring.py``), which needs ``--lm-attention auto`` as in the
  JAX trainer; on one rank the sequence is whole, ``auto`` resolves to
  ``full`` and ``flash`` to the hand-written kernels;
- ``tp``: Megatron tensor parallelism over ``model`` (``parallel/tp.py``),
  ``--lm-attention full`` only (the JAX refusal of flash);
- ``pp``: the GPipe pipeline over ``model`` with ``--lm-microbatches``
  (``parallel/pp.py``), each stage's blocks on ``full`` or ``flash``;
- ``ep``: the MoE LM (``models/moe.py``, ``--lm-experts``,
  ``--lm-moe-top-k``) with its experts sharded over every rank
  (``parallel/ep.py``), attention ``full`` or ``flash``.

tp and pp lay the ranks out as ``data x model`` with ``model =
--lm-model-axis`` (0: every rank), ep as ``data = world, model = 1``; the
batch is sharded over ``data``. Every rank draws the same shared-seed
batch and takes its slice (sp by the sequence, tp, pp and ep by rows), as
the JAX ``globalize_replicated`` places it. The optimizer is the plain
``optim.SGD`` with the configured schedule whatever ``--fused-optimizer``
says, as ``lm_trainer.py:59-63``. STEP lines
carry ``acc 0.0 participating 1.0`` (``:403-407``); the JSONL record adds
``tokens_per_sec``. ``--remat`` recomputes each block in the backward.

``step_time`` runs from fetching the batch to reading the step's loss when
the step is logged, which waits for the device; an unlogged step's time
ends at dispatch.

Checkpoints are the JAX LM's: the ``TrainState`` (step, params, the SGD
state, ``batch_stats={}``) in the JAX layout (``models/convert.py``), with
the config (``network``, ``MoETransformerLM`` for ep, and, for tp and pp,
the resolved ``lm_model_axis`` recorded), under ``--compress-grad``'s
container and ``--ckpt-keep``; written every ``eval_freq`` steps, at the
last step and at a health halt. For tp, pp and ep every rank takes part in
gathering the state (tp writes the plain TransformerLM tree, pp the
stage-stacked ``blocks`` with its momentum mirrored, ep the whole MoE
tree with the experts stacked [E, ...]) and rank 0 alone writes.
``train`` resumes from the newest checkpoint that verifies, walking back
past corrupt ones, refuses one of another geometry (``lm_parallelism``
and ``lm_model_axis`` included) with the JAX message, takes this rank's
slice of it, and prints ``RESUME lm at step k``. As in the JAX package the token loader is not
fast-forwarded: a resumed run draws its batches from the start of the
stream. The fault plane fires ``replica_crash`` at the top of a step and
``ckpt_corrupt`` after a commit.

``evaluate`` runs sp through the same sharded ring forward as training
(never a full-attention model at the global length), tp and pp through
the full-attention oracle (``runtime/lm_eval.py``) on the gathered
parameters, and ep through the JAX ``_oracle_eval_fn``: the whole MoE
model on the gathered parameters with one capacity group a rank and the
trainer's attention kernel; so every rank reports the same loss.

The ops plane is the CNN Trainer's (``runtime/ops_plane.py``), as the JAX
LM trainer's is: spans ``data_wait``, ``host_dispatch``,
``metrics_sync`` and ``checkpoint``, ``mfu`` over every rank's card,
counted from the full-attention model whether ``--lm-attention`` is
``flash`` or ``full``, the exporter (with the fault counters when a fault
spec is set), the watchdogs (on the loss the logged steps read: the LM
step has no grad norm, as in the JAX package), the flight recorder, the
timeline and the profiler window. Rank i > 0 writes its metrics, trace and
flight files with the suffix ``.p<i>``.
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
from ps_pytorch_tpu_torch.models.convert import (
    ep_shard, state_to_jax, tp_shard,
)
from ps_pytorch_tpu_torch.models.moe import MoETransformerLM
from ps_pytorch_tpu_torch.models.transformer import TransformerLM
from ps_pytorch_tpu_torch.optim import SGD, build_schedule
from ps_pytorch_tpu_torch.parallel import dist, ep, pp, tp
from ps_pytorch_tpu_torch.parallel.mesh import make_grid
from ps_pytorch_tpu_torch.parallel.sp import (
    LMTrainStep, make_lm_eval_fn, sequence_shard,
)
from ps_pytorch_tpu_torch.runtime import checkpoint as ckpt
from ps_pytorch_tpu_torch.runtime.coordinator import DistributedKV, KVStore
from ps_pytorch_tpu_torch.runtime.lm_eval import (
    build_lm_oracle, restore_lm, scoring_attention,
)
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
        self.rank, self.world = rank, world = dist.rank(), dist.world()
        self.mode = mode = cfg.lm_parallelism
        # The attention kernel (--lm-attention): "flash" and "full" are
        # sequence-local, legal wherever this rank holds the whole
        # sequence (sp on one rank, tp, pp); sp over several ranks shards
        # the sequence and crosses the shards with ring attention.
        impl = "flash" if cfg.lm_attention == "flash" else "full"
        # The network the LM trains and, for tp and pp, the resolved
        # model axis, recorded in the checkpoint's config
        # (``lm_trainer.py:171-176``).
        resolved = {"network": "TransformerLM"}
        if mode == "sp":
            if world > 1:
                if cfg.lm_attention != "auto":
                    raise ValueError(
                        f"lm_attention={cfg.lm_attention!r} is "
                        f"sequence-local; sp over {world} devices shards "
                        "the sequence and requires ring attention (use "
                        "lm_attention=auto)")
                impl = "ring"
            if cfg.lm_seq_len % world:
                raise ValueError(f"lm_seq_len {cfg.lm_seq_len} not "
                                 f"divisible by {world} devices (sequence "
                                 f"sharding)")
            self.grid = make_grid(data=world, model=1)
        elif mode in ("tp", "pp"):
            deg = cfg.lm_model_axis or world
            if world % deg:
                raise ValueError(f"{world} devices not divisible by "
                                 f"lm_model_axis={deg}")
            self.grid = make_grid(data=world // deg, model=deg)
            if mode == "tp" and impl != "full":
                raise ValueError("lm_attention='flash' is not supported "
                                 "under tp (GSPMD cannot partition the "
                                 "fused kernel over heads); use full")
            if mode == "pp" and cfg.lm_layers % deg:
                raise ValueError(f"lm_layers={cfg.lm_layers} not "
                                 f"divisible into {deg} stages")
            resolved["lm_model_axis"] = deg
        else:
            self.grid = make_grid(data=world, model=1)
            resolved["network"] = "MoETransformerLM"
        self.cfg = cfg = dataclasses.replace(cfg, **resolved)
        axis = self.grid.data if world > 1 and mode == "sp" else None
        # Every rank builds the whole model from the seed, as the JAX
        # trainer inits the unsharded tree, then keeps its part of it.
        geometry = dict(vocab_size=cfg.lm_vocab, n_layers=cfg.lm_layers,
                        n_heads=cfg.lm_heads, d_model=cfg.lm_d_model,
                        max_seq_len=cfg.lm_seq_len, attention_impl=impl,
                        generator=torch.Generator().manual_seed(cfg.seed),
                        remat=cfg.remat)
        if mode == "ep":
            model = MoETransformerLM(n_experts=cfg.lm_experts,
                                     top_k=cfg.lm_moe_top_k, **geometry)
        else:
            model = TransformerLM(axis=axis, **geometry)
        model = model.to(self.device)
        self.opt = SGD(lr=build_schedule(cfg), momentum=cfg.momentum,
                       weight_decay=cfg.weight_decay, nesterov=cfg.nesterov)
        if mode == "sp":
            self.model = model
            self.step_fn = LMTrainStep(model, self.opt, axis)
            self.eval_fn = make_lm_eval_fn(model, axis)
        elif mode == "tp":
            self.model = tp.shard_model_(model, self.grid.model)
            self.step_fn = tp.TPTrainStep(model, self.opt, self.grid,
                                          remat=cfg.remat)
        elif mode == "ep":
            self.model = ep.shard_model_(model, self.grid.data)
            self.step_fn = ep.EPTrainStep(model, self.opt, self.grid.data)
        else:
            self.model = pp.PipelineStage(model, self.grid.model.index, deg)
            self.step_fn = pp.PPTrainStep(self.model, self.opt, self.grid,
                                          cfg.lm_microbatches)
        del model
        train_stream, self.val_tokens = lm_streams(cfg)
        self.train_loader = TokenLoader(train_stream, cfg.batch_size,
                                        cfg.lm_seq_len, seed=cfg.seed)
        self.metrics = MetricsLogger(cfg.metrics_file, cfg.log_every,
                                     printer=printer, process_index=rank,
                                     num_processes=world)
        # Fault plane: step-keyed crashes and the corruption of a
        # committed checkpoint, for resilience drills.
        self.injector = (resilience.FaultInjector(cfg.fault_spec,
                                                  process_index=rank)
                         if cfg.fault_spec else None)
        store = dist.store()
        self.ops = OpsPlane(cfg, device=self.device, rank=rank, world=world,
                            kv=DistributedKV(store) if store is not None
                            else KVStore(), health_extra=lambda: {
                                "leader": rank == 0,
                                "role": "leader" if rank == 0
                                else "follower"},
                            resilience=(self.injector.snapshot
                                        if self.injector else None),
                            printer=printer)
        self.printer = printer
        self.step_times: list = []
        self.start_step = 0

    def _local(self, tokens: np.ndarray) -> np.ndarray:
        """This rank's slice of the shared batch."""
        if self.world == 1:
            return tokens
        if self.mode == "sp":
            return sequence_shard(tokens, self.grid.data)
        return tp.batch_shard(tokens, self.grid.data)

    def full_state(self) -> tuple:
        """(the whole model's parameters, its SGD state) on this rank:
        collective for tp, pp and ep, whose every rank must call it."""
        opt_state = self.step_fn.opt_state
        if self.mode == "sp":
            return self.model, opt_state
        if self.mode == "ep":
            params, momentum = ep.full_state(self.model, opt_state,
                                             self.grid.data)
            return params, opt_state._replace(momentum=momentum)
        gather = tp.full_state if self.mode == "tp" else pp.full_state
        params, momentum = gather(self.model, opt_state, self.grid)
        return params, opt_state._replace(momentum=momentum)

    # ---- checkpoint and resume (the CNN Trainer's layout) ----
    def checkpoint(self, step: int) -> Optional[str]:
        """Commit ``model_step_<step>`` from rank 0 (every rank takes part
        in the gather), let a ``ckpt_corrupt`` fault strike it, then keep
        the newest ``ckpt_keep`` when that is set."""
        cfg = self.cfg
        params, opt_state = self.full_state()
        if self.rank != 0:
            return None
        tree = state_to_jax(params, opt_state, step)
        if self.mode == "pp":
            tree = pp.stack_state_tree(tree, self.grid.model.size)
        path = ckpt.save_checkpoint(
            cfg.train_dir, step, tree, config_json=cfg.to_json(),
            compress=cfg.compress_grad, codec_level=cfg.codec_level)
        if self.injector is not None:
            # After the atomic commit: the torn artifact the manifest
            # check must catch, not a failed write.
            self.injector.after_checkpoint(cfg.train_dir, step)
        if cfg.ckpt_keep > 0:
            ckpt.prune_checkpoints(cfg.train_dir, cfg.ckpt_keep)
        return path

    def _local_part(self):
        """name, whole tensor -> this rank's part of it (None: not held),
        for ``restore_lm``; None when the rank holds the whole model."""
        if self.mode == "tp":
            m = self.grid.model
            return lambda name, t: tp_shard(name, t, m.index, m.size)
        if self.mode == "pp":
            held = set(self.model.state_dict())
            return lambda name, t: t if name in held else None
        if self.mode == "ep":
            d = self.grid.data
            return lambda name, t: ep_shard(name, t, d.index, d.size)
        return None

    def maybe_resume(self) -> bool:
        """Restore the newest checkpoint that verifies (a layout from
        before the q/k/v split migrates on load, a pp checkpoint is
        unstacked) and take this rank's part; a checkpoint of another
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
                tree, self.model, self.step_fn.opt_state, step=step,
                local=self._local_part())
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
                    m = self.step_fn(self._local(tokens))
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
        tail (its first ``max_batches`` batches): sp through the train
        step's sharded forward, tp and pp through the oracle on the
        gathered parameters (flash where the kernels take the head dim,
        ``lm_eval.scoring_attention``), ep through the MoE oracle with
        one capacity group a rank and the trainer's attention (every rank
        takes part)."""
        cfg = self.cfg
        val = TokenLoader(self.val_tokens, cfg.batch_size, cfg.lm_seq_len,
                          seed=0, shuffle=False)
        if self.mode == "sp":
            def loss_of(tokens):
                return float(self.eval_fn(self._local(tokens)))
        else:
            params, _ = self.full_state()
            if self.mode == "ep":
                extra = dict(n_groups=self.grid.data.size,
                             attention_impl=self.model.attention_impl)
            else:
                extra = dict(attention_impl=scoring_attention(cfg))
            oracle, loss_of = build_lm_oracle(cfg, self.device, **extra)
            oracle.load_state_dict(params)
        losses = []
        for i, tokens in enumerate(val.epoch(0)):
            if max_batches is not None and i >= max_batches:
                break
            losses.append(loss_of(tokens))
        self.model.train()
        loss = float(np.mean(losses)) if losses else float("nan")
        return {"loss": loss, "perplexity": float(np.exp(min(loss, 30.0))),
                "batches": len(losses)}
