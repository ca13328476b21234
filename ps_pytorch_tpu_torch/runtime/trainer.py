"""The training loop: the JAX package's ``runtime/trainer.py`` (build
``:51-99``, coordinator ``:115-165``, resume ``:278-301``, checkpoint
``:303-334``, ``train`` ``:517-620``, ``evaluate`` ``:726``), one process a
replica.

announce step -> next batch -> the step's participation mask from the
Coordinator -> step (forward, backward, masked mean over the process
group, update) -> report this replica's duration -> STEP line, and every
``eval_freq`` steps a checkpoint ``model_step_<k>`` for the polling
evaluator (``runtime/evaluator.py``), written by process 0 only. Each
process reads its own shard of the data (``host_id`` = rank; ``batch_size``
is the global batch). The loop keeps the JAX trainer's 1-deep pipeline:
step k is dispatched before step k-1's metrics are read, and the reported
step_time runs from fetching the batch to that read. With ``resume`` on,
every process restores the newest valid checkpoint in ``train_dir`` and
fast-forwards its own shard to it, so the resumed run sees the batches an
uninterrupted one would; a model's Dropout masks are drawn from the step's
key ``seed * 100003 + step`` and the replica (``parallel/dp.py``), so it
draws the masks too.

The ops plane (``runtime/ops_plane.py``) runs beside the loop: spans
``data_wait``, ``host_dispatch``, ``device_sync``, ``metrics_sync`` and
``checkpoint`` on every step, ``mfu`` and the device memory on the STEP
line and in the JSONL, the Prometheus exporter, the health watchdogs
(a ``halt`` commits ``model_step_<k>`` at the step that tripped, dumps the
flight recorder and leaves the loop), the flight dump on a crash, the
cross-process timeline and the ``torch.profiler`` window. The loop's one
wait for the card, where the step's loss is read, reads the step's grad
norm and nonfinite flag in the same copy, so the watchdogs add no device
sync. The Coordinator's KV goes through the resilience shims
(``resilience.wrap_kv_with``), as in the JAX trainer: the fault plane of
``--fault-spec`` inside, the retry plane (``kv_retry_attempts``) outside,
so an injected or real transient store error is retried.

Crash containment, at the JAX trainer's hooks: the ``FaultInjector`` (one
handed in by the auto-resume loop, ``train.py``, or one built from
``--fault-spec``) may crash the process at the top of a step, poisons the
step's mask with NaN (``grad_nan``) and corrupts a checkpoint right after
its commit (``ckpt_corrupt``); with ``--heartbeat-interval-s`` every
process beats on the KV and the leader's ``LivenessMonitor`` masks out a
replica whose beats stopped; SIGTERM makes the loop commit an emergency
checkpoint at the next step boundary and leave. The JSONL carries the
resilience counters (``resilience_stats``) whenever a fault plane or
heartbeats are on, or once the retry plane absorbed an error, and the
exporter serves them.

The control plane, at the JAX trainer's hooks (``:108-200``): with
``--kv-replicas`` the Coordinator's KV is a ``ReplicatedKV``
(``runtime/kvrep.py``) over N independent backends (the per-backend
faults ``kv_backend_kill`` / ``kv_backend_wipe`` inside its quorum, the
retry plane outside it), otherwise the group's TCPStore or an in-process
dict. ``--leader-lease-s`` makes the leader refresh a lease; with
``--elastic`` the initial leader is ``--elastic-leader``, the lease is an
epoch-fenced election (``elastic/election.py``) any follower can win when
it goes stale, a ``MemberAnnouncer`` owns this process's heartbeat and the
leader folds the membership view into the mask. A ``leader_kill`` fault
SIGKILLs whoever leads right after the step's mask is decided. The
checkpoint's meta, the resilience counters and ``/healthz`` carry
``leader_epoch``.

The step's options: ``--sync-batchnorm``, ``--remat`` and
``--shard-update`` (ZeRO-1, ``parallel/zero.py``, whose checkpoints hold
the optimizer state in the JAX ZeRO layout, gathered from every
replica).
"""

import time
from typing import Optional

import numpy as np
import torch

from ps_pytorch_tpu_torch import elastic, resilience
from ps_pytorch_tpu_torch.config import TrainConfig
from ps_pytorch_tpu_torch.data import prepare_data
from ps_pytorch_tpu_torch.data.augment import input_norm_for
from ps_pytorch_tpu_torch.models import build_model
from ps_pytorch_tpu_torch.models.convert import state_from_jax, state_to_jax
from ps_pytorch_tpu_torch.optim import build_optimizer
from ps_pytorch_tpu_torch.parallel import make_eval_step, make_train_step
from ps_pytorch_tpu_torch.parallel import dist
from ps_pytorch_tpu_torch.parallel.dp import accumulate_eval
from ps_pytorch_tpu_torch.runtime import checkpoint as ckpt
from ps_pytorch_tpu_torch.runtime.coordinator import (
    Coordinator, DistributedKV, KVStore,
)
from ps_pytorch_tpu_torch.runtime.kvrep import build_replicated_kv
from ps_pytorch_tpu_torch.runtime.metrics import MetricsLogger
from ps_pytorch_tpu_torch.runtime.ops_plane import OpsPlane
from ps_pytorch_tpu_torch.telemetry import declare_elastic_metrics


def resolve_device(device: Optional[str] = None) -> torch.device:
    """``cuda`` unless the caller asks for another device; a CUDA device
    that is not there raises instead of running on the CPU."""
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to "
                           "run the plain versions on the CPU")
    return dev


def _leader_identity(co) -> dict:
    """The /healthz identity: the run, whether this process leads and,
    with elections, the epoch and its owner."""
    body = {"run_id": co.run_id, "leader": bool(co.leader)}
    if co.election is not None:
        body["leader_epoch"] = co.election.epoch
        body["leader_owner"] = co.election.owner
    return body


def set_reference_numerics() -> None:
    """The arithmetic the port is held to, set where a trainer or the
    evaluator is built: float32 matmuls and cuDNN convolutions in full f32
    (torch runs f32 cuDNN convolutions in TF32 by default); f16 and bf16
    matmuls summed in f32 to the end, as the JAX conv's weight gradient
    (``preferred_element_type=f32``), with no split-K partial reduced in
    the 16-bit type by cuBLAS (on an H100 at ResNet-18's shapes it gave
    the same bf16 weight gradients at the same speed either way, and f16
    ones closer to f32); and deterministic cuDNN algorithms, so that a
    resumed run equals an uninterrupted one bitwise. Process-wide torch
    flags."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True


class Trainer:
    def __init__(self, cfg: TrainConfig, device: Optional[str] = None,
                 printer=print, injector=None):
        set_reference_numerics()
        if cfg.mode not in ("sync", "kofn"):
            raise ValueError(f"the Trainer runs mode='sync' and 'kofn'; mode="
                             f"{cfg.mode!r} is MultiSliceTrainer's "
                             "(runtime/multislice.py)")
        self.cfg = cfg
        self.device = resolve_device(device)
        # One replica a process: in a process group, this process's rank
        # among ``world``; alone, replica 0 of 1.
        self.rank, self.world = dist.local_data_shard()
        self.group = dist.group()
        store = dist.store()
        # Fault plane: an injector handed in (the auto-resume loop keeps
        # one across rebuilds, so once-only faults stay fired) wins over
        # one built from --fault-spec.
        if injector is None and cfg.fault_spec:
            injector = resilience.FaultInjector(cfg.fault_spec,
                                                process_index=self.rank)
        self._kvrep = None
        if cfg.kv_replicas:
            # Quorum replication: masks, lease, election and membership
            # ride N independent backends, and losing a minority of them
            # is a hiccup, not a dead control plane.
            base = self._kvrep = build_replicated_kv(
                cfg, process_index=self.rank, injector=injector)
        else:
            base = DistributedKV(store) if store is not None else KVStore()
        kv, self.injector, self._retrier = resilience.wrap_kv_with(
            base, cfg, injector)
        # Leadership is a lease under --elastic, not an address: the
        # initial leader is --elastic-leader (keep it off process 0, which
        # serves the TCPStore), and every process gets the election and a
        # liveness factory, since any follower may be promoted.
        leader = self.rank == 0
        election = membership = liveness_factory = None
        hb_timeout = cfg.heartbeat_timeout_s or 3 * (
            cfg.heartbeat_interval_s or cfg.leader_lease_s)
        if cfg.elastic:
            initial = cfg.elastic_leader % self.world
            leader = self.rank == initial
            election = elastic.LeaderElection(
                kv, "run", self.rank, self.world,
                interval_s=cfg.leader_lease_s, preferred=initial)
            membership = elastic.MembershipRegistry(
                kv, "run", self.world, self.world, timeout_s=hb_timeout)
            liveness_factory = lambda: resilience.LivenessMonitor(  # noqa
                kv, "run", self.world, timeout_s=hb_timeout)
            if leader:
                election.claim_initial()
        self.coordinator = Coordinator(
            self.world, mode=cfg.mode, num_aggregate=cfg.num_aggregate,
            kill_threshold=cfg.kill_threshold, kv=kv, leader=leader,
            lease_interval_s=cfg.leader_lease_s, election=election,
            membership=membership, liveness_factory=liveness_factory)
        # Liveness: every process beats for its replica; the leader folds
        # missed beats into the mask (crashed is not slow). Under
        # --elastic the MemberAnnouncer owns the beat (the same hb/ keys,
        # plus the join the membership registry folds in).
        self.heartbeat = None
        self.announcer = None
        if election is not None:
            self.announcer = elastic.MemberAnnouncer(
                kv, self.coordinator.run_id, self.rank, [self.rank],
                interval_s=cfg.heartbeat_interval_s or cfg.leader_lease_s)
            self.announcer.join()
            self.heartbeat = self.announcer.heartbeat
        elif cfg.heartbeat_interval_s > 0:
            self.heartbeat = resilience.Heartbeat(
                kv, self.coordinator.run_id, [self.rank],
                interval_s=cfg.heartbeat_interval_s)
        if self.heartbeat is not None and self.coordinator.leader and \
                self.coordinator.liveness is None:
            self.coordinator.liveness = resilience.LivenessMonitor(
                kv, self.coordinator.run_id, self.world,
                timeout_s=hb_timeout)
        # SIGTERM (preemption): the handler only flags; the loop writes an
        # emergency checkpoint at the next step boundary.
        self._preempt = resilience.PreemptionGuard()
        # Before the step: the nonfinite:skip watchdog sets its gate. The
        # /healthz identity holds the coordinator, not the trainer, so the
        # trainer is freed (its tensors with it) when the last reference
        # goes, not at the next cycle collection.
        co = self.coordinator
        planes = [t for t in (self.injector, self._retrier)
                  if t is not None]
        self.ops = OpsPlane(
            cfg, device=self.device, rank=self.rank, world=self.world,
            kv=co.kv, run_id=co.run_id,
            health_extra=lambda: _leader_identity(co),
            resilience=(lambda: {k: v for t in planes
                                 for k, v in t.snapshot().items()})
            if planes else None,
            kvrep=self._kvrep, printer=printer)
        if election is not None:
            declare_elastic_metrics(self.ops.registry)
            self._elastic_drained = {"coord": 0, "member": 0, "elect": 0}
            self._last_member_epoch = 0
        self.model = build_model(cfg.network, cfg.num_classes,
                                 cfg.compute_dtype, cfg.conv_impl,
                                 seed=cfg.seed).to(self.device)
        self.opt = build_optimizer(cfg)
        self.train_loader, self.test_loader = prepare_data(
            cfg, host_id=self.rank, num_hosts=self.world)
        input_norm = input_norm_for(cfg)
        self.step_fn = make_train_step(
            self.model, self.opt, group=self.group, input_norm=input_norm,
            skip_nonfinite=self.ops.skip_nonfinite,
            sync_batchnorm=cfg.sync_batchnorm, remat=cfg.remat,
            shard_update=cfg.shard_update)
        self.eval_fn = make_eval_step(self.model, input_norm)
        self.metrics = MetricsLogger(cfg.metrics_file, cfg.log_every,
                                     printer=printer,
                                     process_index=self.rank,
                                     num_processes=self.world)
        # Per step: the wall time, and the part of it spent waiting on the
        # other replicas (the mask wait and the all-reduces).
        self.step_times: list = []
        self.wait_times: list = []
        self.start_step = 0
        if cfg.resume:
            self._maybe_resume()

    def _restore(self, tree: dict) -> None:
        """Put a checkpoint's state into the model and the optimizer, in
        place; this replica's BatchNorm statistics where it has them, and
        under ``--shard-update`` this replica's row of the sharded
        optimizer state."""
        if self.cfg.shard_update:
            self.step_fn.restore_opt_state(tree["opt_state"])
            state_from_jax(tree, self.model, replica=self.rank)
            return
        self.step_fn.opt_state, _ = state_from_jax(
            tree, self.model, self.step_fn.opt_state, replica=self.rank)

    def _maybe_resume(self) -> None:
        """Restore the newest checkpoint that verifies, walking back past
        corrupt ones, and replay this process's data stream to it."""
        got = ckpt.load_latest_valid(self.cfg.train_dir, self._restore)
        if got is None:
            return
        _, meta, _, step = got
        self.start_step = int(meta["step"])
        self.train_loader.fast_forward(self.start_step)
        print(f"RESUME from {ckpt.checkpoint_path(self.cfg.train_dir, step)} "
              f"at step {self.start_step}")

    def _replica_buffers(self) -> Optional[list]:
        """Every replica's BatchNorm buffers, gathered to every process (a
        collective: all processes call it), or None in one process."""
        own = dict(self.model.named_buffers())
        if self.group is None or not own:
            return None
        flat = torch.cat([b.reshape(-1) for b in own.values()])
        parts = [torch.empty_like(flat) for _ in range(self.world)]
        torch.distributed.all_gather(parts, flat, group=self.group)
        sizes = [b.numel() for b in own.values()]
        return [{name: t.view_as(b) for (name, b), t in
                 zip(own.items(), part.split(sizes))} for part in parts]

    def checkpoint(self, step: int) -> Optional[str]:
        """Commit ``model_step_<step>`` with every replica's BatchNorm
        statistics (and, under ``--shard-update``, every replica's slice
        of the optimizer state), let a ``ckpt_corrupt`` fault strike it,
        then keep the newest ``ckpt_keep`` when that is set. Every process
        calls it; process 0 writes and returns the path, the others return
        None."""
        replica_buffers = self._replica_buffers()
        opt_tree = (self.step_fn.gather_opt_state()
                    if self.cfg.shard_update else None)
        if self.rank != 0:
            return None
        extra = None
        if self.coordinator.election is not None:
            # Which leadership epoch committed these weights.
            extra = {"leader_epoch": self.coordinator.election.epoch,
                     "leader_pid": self.rank}
        path = ckpt.save_checkpoint(
            self.cfg.train_dir, step,
            state_to_jax(self.model, self.step_fn.opt_state, step,
                         replica_buffers, opt_tree),
            config_json=self.cfg.to_json(), compress=self.cfg.compress_grad,
            codec_level=self.cfg.codec_level, extra_meta=extra)
        if self.injector is not None:
            # After the atomic commit: the torn artifact the manifest
            # check must catch, not a failed write.
            self.injector.after_checkpoint(self.cfg.train_dir, step)
        if self.cfg.ckpt_keep > 0:
            ckpt.prune_checkpoints(self.cfg.train_dir, self.cfg.ckpt_keep)
        return path

    def resilience_stats(self) -> dict:
        """Flat counters of every resilience plane that is on: the fault
        injector's, the retry plane's, the replicated KV's, the liveness
        monitor's, the leader's mask changes and, under --elastic, the
        leadership epoch, the elections, the membership changes and the
        world size."""
        co = self.coordinator
        out: dict = {}
        for plane in (self.injector, self._retrier, self._kvrep,
                      co.liveness):
            if plane is not None:
                out.update(plane.snapshot())
        out["mask_changes"] = co.stats.get("mask_changes", 0)
        if co.election is not None:
            out["leader_epoch"] = co.election.epoch
            out["elections"] = co.stats.get("elections", 0)
        if co.membership is not None:
            m = co.membership.snapshot()
            out["membership_changes"] = m["membership_changes"]
            out["world_size"] = m["world_size"] or self.world
        return out

    def _resilience_active(self) -> bool:
        """The JAX trainer's schema gate: a run with no fault plane, no
        heartbeats and no elections keeps the plain JSONL until the retry
        plane absorbed an error."""
        if self.injector is not None or self.heartbeat is not None or \
                self.cfg.elastic:
            return True
        s = self._retrier.snapshot() if self._retrier is not None else {}
        return bool(s.get("kv_retries") or s.get("kv_giveups"))

    def _elastic_step(self, step: int) -> None:
        """A step's elastic bookkeeping (the JAX trainer's ``:426-460``):
        the leader-epoch and world-size gauges, the membership-change and
        election counters, and the election and membership events into
        the flight recorder. On a membership-epoch change under
        ``--shard-update`` the shard plan of the new member count is
        printed and recorded."""
        co, r = self.coordinator, self.ops.registry
        el, mem = co.election, co.membership
        r.set("leader_epoch", el.epoch)
        snap = mem.snapshot()
        r.set("world_size", snap["world_size"] or self.world)
        for name, value in (("membership_changes",
                             snap["membership_changes"]),
                            ("elections", co.stats.get("elections", 0))):
            if value > r.get(name):
                r.inc(name, value - r.get(name))
        flight = self.ops.flightrec
        if flight is not None:
            for src, events in (("coord", co.events),
                                ("member", mem.events),
                                ("elect", el.events)):
                kind = "membership" if src == "member" else "election"
                for ev in events[self._elastic_drained[src]:]:
                    flight.record_event(kind, dict(ev))
                self._elastic_drained[src] = len(events)
        if mem.epoch != self._last_member_epoch:
            self._last_member_epoch = mem.epoch
            if self.cfg.shard_update and mem.members:
                size = sum(p.numel() for p in self.model.parameters())
                n = len(mem.members)
                chunk = -(-size // n)
                print(f"REBALANCE shard plan epoch {mem.epoch}: "
                      f"{n} shards x {chunk} params")
                if flight is not None:
                    flight.record_event("shard_replan", {
                        "epoch": mem.epoch, "n_shards": n, "chunk": chunk,
                        "step": step})

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def train(self) -> None:
        """Run to max_steps or epochs * steps-per-epoch, whichever is
        smaller, from ``start_step``; checkpoint every ``eval_freq`` steps
        and at a last step that is not a multiple of it.

        The duration this replica reports to the Coordinator is its own
        time: the step's wall time less the time it waited on the other
        replicas (for the mask, in the all-reduces). Every rank of a
        synchronous group runs at the slowest one's pace, so the wall times
        of all ranks are the same and cannot tell the straggler."""
        cfg = self.cfg
        co, ops, tracer = self.coordinator, self.ops, self.ops.tracer
        steps_per_epoch = max(len(self.train_loader), 1)
        epoch_budget = (cfg.epochs * steps_per_epoch if cfg.epochs > 0
                        else cfg.max_steps)
        last_step = min(cfg.max_steps, epoch_budget)
        slow = cfg.inject_step_delay > 0 \
            and self.rank == cfg.inject_delay_process
        step, halted, preempted = self.start_step, False, False
        self._preempt.install()
        try:
            while step < last_step:
                step += 1
                if self.injector is not None:
                    # Before any KV or device work: a process dying
                    # between steps, recovered from the last commit.
                    self.injector.maybe_crash(step)
                ops.count_flops()
                ops.profile_step(step)
                co.announce_step(step)
                if self.heartbeat is not None:
                    self.heartbeat.beat(step)
                t0 = time.monotonic()
                with tracer.span("data_wait", step=step):
                    x, y = self.train_loader.next_batch()
                t_data = time.monotonic() - t0
                mask = co.participation_mask(step)
                t_mask = time.monotonic() - t0 - t_data
                if self.injector is not None:
                    # Role-addressed, after the mask decision: the leader
                    # dies with this step's mask published, the worst
                    # handoff (followers consume it, then find the lease
                    # stale at the next step and elect).
                    self.injector.maybe_kill_leader(step,
                                                    is_leader=co.leader)
                if self.injector is not None and \
                        self.injector.maybe_poison(step):
                    # grad_nan: the NaN rides the mask into the step's
                    # reductions (loss, gradient, norm); the NaN mask also
                    # fails the msum > 0 gate, so the parameters stay.
                    mask = np.asarray(mask, np.float32) * np.nan
                    print(f"FAULT grad_nan: poisoned mask at step {step}")
                    if ops.flightrec is not None:
                        ops.flightrec.record_event("fault_grad_nan",
                                                   {"step": step})
                with tracer.span("host_dispatch", step=step):
                    m = self.step_fn(x, y, mask,
                                     key=cfg.seed * 100003 + step)
                if slow:
                    # Fault injection: make this process a straggler.
                    time.sleep(cfg.inject_step_delay)
                with tracer.span("device_sync", step=step):
                    # The loop's one wait for the card: the step's
                    # scalars in one copy (on one CUDA stream, reading
                    # any of the step's outputs waits for all of it).
                    loss, acc, grad_norm, nonfinite = torch.stack(
                        [m["loss"], m["accuracy"], m["grad_norm"],
                         m["nonfinite"]]).tolist()
                t_step = time.monotonic() - t0
                t_wait = t_mask + self.step_fn.comm_s
                self.step_times.append(t_step)
                self.wait_times.append(t_wait)
                co.report_duration(self.rank, step, t_step - t_wait)
                ops.ops_step(step, examples=cfg.batch_size, loss=loss,
                             grad_norm=grad_norm, nonfinite=nonfinite,
                             step_time=t_step, data_time=t_data)
                if co.election is not None:
                    self._elastic_step(step)
                if ops.should_halt:
                    ops.halt(step, self.checkpoint)
                    halted = True
                    break
                resil = (self.resilience_stats()
                         if self._resilience_active() else {})
                ops.publish_step(step, t_step, t_data, resil)
                if step % cfg.log_every == 0 or step == last_step:
                    with tracer.span("metrics_sync", step=step):
                        part = float(m["participating"])
                    self.metrics.log_step(
                        step, (step - 1) // steps_per_epoch, loss=loss,
                        acc=acc, participating=part, step_time=t_step,
                        data_time=t_data,
                        phases=tracer.step_summary(step),
                        **ops.derived(step_time=t_step, data_time=t_data,
                                      examples=cfg.batch_size),
                        **resil)
                if cfg.eval_freq > 0 and step % cfg.eval_freq == 0:
                    with tracer.span("checkpoint", step=step):
                        self.checkpoint(step)
                if self._preempt.triggered:
                    # SIGTERM: an emergency checkpoint at this step
                    # boundary, then leave, for auto-resume or the next
                    # scheduling to restore.
                    with tracer.span("checkpoint", step=step):
                        self.checkpoint(step)
                    print(f"PREEMPT emergency checkpoint at step {step}")
                    if ops.flightrec is not None:
                        ops.flightrec.dump("sigterm", extra={"step": step})
                    preempted = True
                    break
            self._sync()
            if cfg.eval_freq > 0 and step > self.start_step \
                    and step % cfg.eval_freq != 0 and not halted \
                    and not preempted:
                with tracer.span("checkpoint", step=step):
                    self.checkpoint(step)
        except BaseException as e:
            ops.crash(e)
            raise
        finally:
            self._preempt.uninstall()
            self.metrics.close()
            ops.close(final_step=step)

    def evaluate(self, max_batches: Optional[int] = None) -> dict:
        """Loss, top-1 and top-5 over the test loader (or its first
        ``max_batches`` batches), each process over the whole test set with
        replica 0's BatchNorm statistics (broadcast from process 0; a
        collective), as the JAX trainer evaluates; its own statistics are
        put back after."""
        bufs = [b for _, b in self.model.named_buffers()]
        own = None
        if self.group is not None and bufs:
            own = [b.clone() for b in bufs]
            flat = torch.cat([b.reshape(-1) for b in bufs])
            torch.distributed.broadcast(flat, 0, group=self.group)
            self._copy_into(bufs, flat.split([b.numel() for b in bufs]))
        try:
            return accumulate_eval(self.eval_fn, self.test_loader.epoch(0),
                                   max_batches)
        finally:
            self.model.train()
            if own is not None:
                self._copy_into(bufs, own)

    @staticmethod
    @torch.no_grad()
    def _copy_into(dst: list, src) -> None:
        for d, s in zip(dst, src):
            d.copy_(s.view_as(d))
