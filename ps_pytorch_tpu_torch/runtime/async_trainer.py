"""Asynchronous (stale-gradient) training across processes: the JAX
package's ``runtime/async_trainer.py``, one slice a process, gradients
crossing the process boundary as codec-compressed bytes over the KV
(``parallel/transport.py``).

This is the reference's multi-machine async path: workers ship
staleness-tagged gradients to a master (``resnet_split.py:25-42``,
``sync_replicas_master_nn.py:156-186``).

- Each process trains one copy of the model on its own device and its own
  shard of the data (``host_id`` = rank).
- Process 0 is the PS leader: it owns the optimizer state, pools the
  processes' contributions with their staleness
  (``parallel/async_dp.py:StaleGradientAggregator``), applies at most one
  update a tick (through the fused SGD kernel under
  ``--fused-optimizer``), publishes the canonical weights every
  ``publish_every`` updates and writes the checkpoints.
- Followers fetch the canonical weights every ``fetch_every`` of their
  own steps, so a slow follower submits stale gradients.
- Every process scores the canonical state: the parameters and the
  leader's BatchNorm statistics of the final publish.

The wire carries the JAX package's tree, byte for byte: the flax
parameter tree with sorted keys, conv kernels HWIO and dense kernels
[in,out]. Each leaf is laid out that way on the device before it is
encoded and back after it is decoded (``models/convert.py:leaf_layout``).
The gradient codecs:

- off (``raw``) and ``blosc``: the f32 gradient, framed by the channel;
- ``int8``: one launch of the hand-written quantize kernel over the whole
  JAX-layout tree (``ops/quantize.py:quantize_tree``), before the bytes
  leave the card; leaf i travels as ``{"v": int8 [R,128], "s": f32
  [R/32,1]}``, blosc-framed. Its rounding noise is Philox under the key
  made of ``seed * 31 + seq * n + pid`` (the JAX package's threefry key)
  and i; ``noise_fn`` injects other noise. The leader dequantizes on the
  device and averages there;
- ``int8lat`` / ``topk`` / ``randk``: homomorphic payloads summed in the
  compressed domain on the leader, with sender-side error feedback
  (``--ef``).

Across processes the KV is the process group's TCPStore
(``DistributedKV``), alone an in-process ``KVStore``, or with
``--kv-replicas`` a ``ReplicatedKV`` (``runtime/kvrep.py``), either behind
the fault plane (``--fault-spec``) and the retry plane
(``resilience.wrap_kv_with``). Process 0 serves the store: ``leave()``
holds it until every process has read the final state, and skips a
process the membership evicted (one that died without leaving).

With ``--elastic`` the PS leader is a lease, not process 0 (the JAX
trainer's ``:125-160``, ``:644-723``): the initial leader is
``--elastic-leader``, and it claims the epoch-numbered lease
(``elastic/election.py``) after its first tick, once the kernels of that
tick are built and loaded, so the first tick's build time cannot make the
lease look stale. Every tick each process beats for itself
(``MemberAnnouncer``); the leader refreshes the lease and folds the
membership; a follower that finds the lease stale campaigns, and the
winner promotes itself (``_promote``): it builds the optimizer and the
pool, restores the optimizer state and the BatchNorm statistics from the
newest valid checkpoint, moves forward to the freshest canonical publish
on the KV, prints ``ELECTED async leader ...`` and publishes at once. A
leader whose refresh finds a higher epoch demotes itself (``DEPOSED``).
The fault plane fires ``replica_crash`` and ``leader_kill`` at the top of
a tick (keyed on the process's own ticks) and ``ckpt_corrupt`` after a
commit; the checkpoint's meta carries ``leader_epoch``.

A resume restores the leader's parameters, optimizer state, BatchNorm
statistics and error-feedback residuals, and, beyond the JAX trainer, its
sequence number and its data stream: the leader applies exactly one
update a tick (its own contribution is always fresh), so its sequence
number is the version, and a resumed run is bitwise the uninterrupted one.

The leader screens its pool before the sum (``--grad-integrity``, on by
default as in the JAX package; ``resilience/integrity.py``): a
contribution with a non-finite leaf, an int8lat exponent out of bounds or
a norm the MAD gate flags is absent that round and earns its contributor
a strike; three strikes quarantine it, three clean screens readmit it.
The raw / blosc / int8 pools hold f32 tensors on the device, screened
where they lie; the homomorphic pools hold host payloads. The quarantine
and readmission lines (``INTEGRITY ...``) and a summary line at the end
are the JAX trainer's, word for word. The fault ``grad_poison`` scales
this process's own gradients before encode.

``--shard-wire`` (``parallel/zero_wire.py``) replaces the leader's update
with the sharded host-side one over the KV: the leader owns every one of
``max(n, 2)`` shards, publishes the canonical parameters a shard a key
(the transport's parameter channel then carries the BatchNorm statistics
only), and checkpoints the sharded optimizer state as
``extra_state["zero"]``, which a resume and a promoted leader restore. It
runs on the JAX-layout wire tree and writes the result back into the
port's layouts on the device.

The registry of the JAX trainer is kept, and with ``--metrics-port`` its
exporter serves it on ``metrics_port + pid`` (the integrity, resilience,
replicated-KV and elastic counters pumped at each scrape).

``--sync-topology hier`` (``parallel/hierarchy.py``) puts the
``HierarchicalKVTransport`` in place of the flat wire: each process
publishes to its group's channel, whoever holds the group's lease (the
lowest member first, ``--leader-lease-s`` its interval) screens its
members with a member-space ledger, re-encodes the group's average once
and publishes it up, and the leader's pool is a ``RootAggregator`` over
the group ids with a ledger of its own. The leader applies the root
average through the same optimizer (the fused SGD / Adam kernel). The
root's partition and regraft of a silent subtree, the failovers and a
summary at the end print the JAX trainer's ``HIER`` / ``HIERARCHY``
lines, and the ``hierarchy_*`` counters reach the registry and the JSONL.
"""

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ps_pytorch_tpu_torch import elastic, resilience
from ps_pytorch_tpu_torch.compression.codecs import (
    HOMOMORPHIC_GRAD_CODECS, ErrorFeedback, encode_leaves, is_payload,
)
from ps_pytorch_tpu_torch.config import TrainConfig
from ps_pytorch_tpu_torch.data.augment import input_norm_for
from ps_pytorch_tpu_torch.data.datasets import DataLoader, load_arrays
from ps_pytorch_tpu_torch.models import build_model
from ps_pytorch_tpu_torch.models.convert import (
    jax_path, leaf_layout, nest, state_from_jax, state_to_jax,
)
from ps_pytorch_tpu_torch.ops.quantize import (
    LANES, QuantizedTensor, dequantize_int8, padded_rows, quantize_tree,
)
from ps_pytorch_tpu_torch.optim import build_optimizer
from ps_pytorch_tpu_torch.parallel import dist
from ps_pytorch_tpu_torch.parallel.async_dp import (
    StaleGradientAggregator, tree_flatten,
)
from ps_pytorch_tpu_torch.parallel.dp import accumulate_eval, make_eval_step
from ps_pytorch_tpu_torch.parallel.hierarchy import (
    HierarchicalKVTransport, RootAggregator,
)
from ps_pytorch_tpu_torch.parallel.transport import KVGradientTransport
from ps_pytorch_tpu_torch.parallel.zero_wire import updater_from_config
from ps_pytorch_tpu_torch.resilience.integrity import GradIntegrity
from ps_pytorch_tpu_torch.runtime import checkpoint as ckpt
from ps_pytorch_tpu_torch.runtime.coordinator import DistributedKV, KVStore
from ps_pytorch_tpu_torch.runtime.kvrep import build_replicated_kv
from ps_pytorch_tpu_torch.runtime.metrics import MetricsLogger
from ps_pytorch_tpu_torch.runtime.multislice import make_slice_grad_fn
from ps_pytorch_tpu_torch.runtime.trainer import (
    resolve_device, set_reference_numerics,
)
from ps_pytorch_tpu_torch.telemetry import (
    MetricsExporter, Registry, Tracer, declare_elastic_metrics,
    declare_hierarchy_metrics, declare_integrity_metrics,
    declare_kvrep_metrics,
    declare_resilience_metrics, declare_training_metrics,
    device_memory_record, host_rss_bytes, set_default_tracer,
)

_U32 = 0xFFFFFFFF


def _is_quantized(x) -> bool:
    return isinstance(x, dict) and "v" in x


def quantize_wire(leaves: List[torch.Tensor], key: int,
                  noise: Optional[List[torch.Tensor]] = None) -> List[dict]:
    """The int8 wire form of a JAX-layout gradient tree's leaves: one
    ``quantize_tree`` launch (the plain version for CPU tensors), leaf i
    as ``{"v": int8 [R,128], "s": f32 [R/32,1]}``. The rounding noise of
    leaf i is ``noise[i]``, else Philox under the 64-bit ``key`` (the JAX
    trainer's threefry seed) and i."""
    qts = quantize_tree(leaves, (key & _U32, (key >> 32) & _U32), noise)
    return [{"v": q.values, "s": q.scales} for q in qts]


class AsyncTrainer:
    """PS-style asynchronous training, one slice a process.

    ``kv``: the store of the wire (default: the process group's TCPStore
    across processes, an in-process ``KVStore`` alone). ``device``: cuda
    (default) or cpu. ``noise_fn(pid, seq, leaf_index, shape) -> f32
    tensor``: the int8 codec's rounding noise of a leaf; None draws it in
    the kernel (Philox)."""

    def __init__(self, cfg: TrainConfig, kv=None, device: Optional[str] = None,
                 printer=print, noise_fn: Optional[Callable] = None):
        set_reference_numerics()
        self.cfg = cfg
        self.pid, self.n = dist.rank(), dist.world()
        self.leader = self.pid == 0
        self.device = dist.local_device(str(resolve_device(device)))
        self.noise_fn = noise_fn
        self.model = build_model(cfg.network, cfg.num_classes,
                                 cfg.compute_dtype, cfg.conv_impl,
                                 seed=cfg.seed).to(self.device)
        self.params: Dict[str, torch.nn.Parameter] = dict(
            self.model.named_parameters())
        # The wire's leaf order: the port's sorted names are the flax
        # paths' sorted order ("." sorts below every character of a name).
        self.names = sorted(self.params)
        self._paths = [jax_path(n, self.params[n].dim()) for n in self.names]
        if sorted(self._paths) != self._paths:
            raise ValueError("the parameters' names do not sort as their "
                             "flax paths")
        self._jax_shapes = [tuple(leaf_layout(n, self.params[n], True).shape)
                            for n in self.names]
        buffers = dict(self.model.named_buffers())
        self._stat_names = sorted(buffers)
        stat_leaf = {"running_mean": "mean", "running_var": "var"}
        self._stat_paths = [tuple(n.split(".")[:-1])
                            + (stat_leaf[n.rsplit(".", 1)[1]],)
                            for n in self._stat_names]

        # The injector comes before the KV, so the per-backend kinds
        # (kv_backend_kill / wipe) go INSIDE the quorum layer while the
        # logical kinds wrap outside it.
        injector = None
        if cfg.fault_spec:
            injector = resilience.FaultInjector(cfg.fault_spec,
                                                process_index=self.pid)
        self._kvrep = None
        if kv is None:
            if cfg.kv_replicas:
                kv = self._kvrep = build_replicated_kv(
                    cfg, process_index=self.pid, injector=injector)
            else:
                store = dist.store()
                kv = DistributedKV(store) if store is not None \
                    else KVStore()
        # The fault plane inside, the retry plane outside: the transport
        # sees one hardened KV.
        kv, self.injector, self._retrier = resilience.wrap_kv_with(
            kv, cfg, injector)
        # --shard-wire publishes the parameters a shard a key through this
        # same hardened KV.
        self._kv = kv
        self._zw_rd = None           # the followers' reader-mode updater
        self._zw_ptr_version = -1    # the version whose shards are on the KV
        self.run_id = f"async-{cfg.seed}"
        # The elastic control plane: the PS-leader role becomes a lease.
        self.election = None
        self.membership = None
        self.announcer = None
        self.elect_latency_s = 0.0
        self._claim_pending = False
        if cfg.elastic:
            initial = cfg.elastic_leader % max(self.n, 1)
            self.leader = self.pid == initial
            lease_s = cfg.leader_lease_s or 1.0
            self.election = elastic.LeaderElection(
                kv, self.run_id, self.pid, self.n, interval_s=lease_s,
                preferred=initial)
            self.announcer = elastic.MemberAnnouncer(
                kv, self.run_id, self.pid, [self.pid],
                interval_s=cfg.heartbeat_interval_s or lease_s)
            self._hb_timeout = cfg.heartbeat_timeout_s or 3 * (
                cfg.heartbeat_interval_s or lease_s)
            # One "replica" a process: membership tracks processes.
            self.membership = elastic.MembershipRegistry(
                kv, self.run_id, self.n, self.n,
                timeout_s=self._hb_timeout)
            self._claim_pending = self.leader
            self.announcer.join()

        # The gradient codec of the wire (--compress-grad / --grad-codec):
        # off -> raw npy framing; blosc -> the native lossless container;
        # int8 -> the quantize kernel on the card, its components blosc
        # framed; int8lat / topk / randk -> homomorphic payloads.
        self._wire_int8 = cfg.compress_grad and cfg.grad_codec == "int8"
        self._wire_homo = cfg.compress_grad and \
            cfg.grad_codec in HOMOMORPHIC_GRAD_CODECS
        self._ef: Optional[ErrorFeedback] = None   # sender residuals (--ef)
        self._enc_pool: Optional[ThreadPoolExecutor] = None
        chan_codec = "blosc" if cfg.compress_grad else "raw"
        zeros = [np.zeros(s, np.float32) for s in self._jax_shapes]
        if self._wire_homo:
            # Payload shapes do not depend on the data: one throwaway
            # encode of zeros fixes the wire's structure.
            grad_template = nest(self._paths, encode_leaves(
                cfg.grad_codec, zeros, slice_id=0, step=0,
                frac=cfg.grad_topk_frac))
        elif self._wire_int8:
            grad_template = nest(self._paths, [
                {"v": np.zeros(0, np.int8), "s": np.zeros(0, np.float32)}
                for _ in self.names])
        else:
            grad_template = nest(self._paths, zeros)
        # Under --shard-wire the parameters travel as zw shard keys; only
        # the BatchNorm statistics ride the transport's parameter channel.
        param_template = {"bs0": nest(self._stat_paths, [
            np.zeros(0, np.float32) for _ in self._stat_names])}
        if not cfg.shard_wire:
            param_template["params"] = nest(self._paths, zeros)
        wire_bucket_bytes = int(cfg.wire_bucket_mb * (1 << 20))
        self._wire_overlap = wire_bucket_bytes > 0
        self._hier = cfg.sync_topology == "hier"
        # The screens (--grad-integrity): the leader's ledger over the
        # contributors of its pool and, under hier, a member-space ledger
        # on the group hop (whichever process holds the group's lease
        # screens its members).
        self._integrity: Optional[GradIntegrity] = None
        self._group_integrity: Optional[GradIntegrity] = None
        if self._hier:
            # Members publish to their group's channels, the group
            # aggregator re-encodes one payload a group upward, the root
            # (the PS leader) pools the group aggregates. The config
            # already holds the codec homomorphic.
            self._group_integrity = self._make_integrity()
            self.transport = HierarchicalKVTransport(
                kv, self.n, grad_template=grad_template,
                param_template=param_template, run_id=self.run_id,
                pid=self.pid, group_size=cfg.sync_group_size,
                codec=cfg.grad_codec, staleness_limit=cfg.staleness_limit,
                topk_frac=cfg.grad_topk_frac, chan_codec=chan_codec,
                level=cfg.codec_level, bucket_bytes=wire_bucket_bytes,
                workers=cfg.wire_workers, hop_retries=cfg.hier_hop_retries,
                lease_interval_s=cfg.leader_lease_s or 1.0,
                integrity=self._group_integrity)
            print(f"HIER topology pid {self.pid}: "
                  f"{self.transport.describe()}", flush=True)
        else:
            self.transport = KVGradientTransport(
                kv, self.n, grad_template=grad_template,
                param_template=param_template, run_id=self.run_id,
                level=cfg.codec_level, codec=chan_codec,
                bucket_bytes=wire_bucket_bytes, workers=cfg.wire_workers)

        # This process is shard pid of n over the shared-seed shuffle and
        # draws cfg.batch_size a step, like a reference worker.
        self._input_norm = input_norm_for(cfg)
        dev_norm = self._input_norm is not None
        xtr, ytr = load_arrays(cfg.dataset, cfg.data_dir, train=True,
                               seed=cfg.seed)
        self.train_loader = DataLoader(
            xtr, ytr, cfg.batch_size * self.n, cfg.dataset, train=True,
            seed=cfg.seed, host_id=self.pid, num_hosts=self.n,
            device_normalize=dev_norm)
        xte, yte = load_arrays(cfg.dataset, cfg.data_dir, train=False,
                               seed=cfg.seed)
        self.test_loader = DataLoader(xte, yte, cfg.test_batch_size,
                                      cfg.dataset, train=False, shuffle=False,
                                      seed=cfg.seed, drop_last=False,
                                      device_normalize=dev_norm)
        self.grad_fn = make_slice_grad_fn(self.model, self._input_norm)
        self.eval_fn = make_eval_step(self.model, self._input_norm)

        self.metrics = MetricsLogger(cfg.metrics_file, cfg.log_every,
                                     printer=printer, process_index=self.pid,
                                     num_processes=self.n)
        # Ambient tracer: the transport's wire spans land here beside the
        # loop's own.
        self.tracer = Tracer(pid=self.pid)
        self._prev_tracer = set_default_tracer(self.tracer)
        # The JAX trainer's ops plane, lighter than the sync trainer's:
        # gauges and the step counter, no watchdogs. The exporter binds
        # metrics_port + pid, one endpoint a process.
        self.registry = declare_training_metrics(Registry())
        if cfg.elastic:
            declare_elastic_metrics(self.registry)
        if self._hier:
            declare_hierarchy_metrics(self.registry)
        collect = []
        if self.injector is not None or self._retrier is not None:
            declare_resilience_metrics(self.registry)
            collect.append(self._pump_resilience_metrics)
        if self._kvrep is not None:
            declare_kvrep_metrics(self.registry)
            collect.append(self._pump_kvrep_metrics)
        if cfg.grad_integrity:
            declare_integrity_metrics(self.registry)
            collect.append(self._pump_integrity_metrics)
        self.exporter: Optional[MetricsExporter] = None
        if cfg.metrics_port > 0:
            self.exporter = MetricsExporter(
                self.registry, port=cfg.metrics_port + self.pid,
                health_fn=self._health_status, collect=collect).start()
        self.last_publish_s = 0.0
        self.version = 0        # canonical PS step (leader-owned)
        self.applied = 0
        self.dropped_stale = 0
        self.own_steps = 0      # this process's contributions this run
        self._seq = 0
        if self.leader:
            self._build_leader()

    def _build_leader(self) -> None:
        """The leader's own machinery: the optimizer and its state, and the
        pool. Homomorphic payloads enter the pool as payloads and are
        summed in the compressed domain; every other codec is decoded to
        f32 on the device first, and the pool averages there."""
        self.opt = build_optimizer(self.cfg)
        self.opt_state = self.opt.init(self.params)
        self.aggregator = self._make_leader_aggregator()

    def _make_integrity(self) -> Optional[GradIntegrity]:
        """One screening ledger (--grad-integrity): payload validation,
        the MAD outlier gate and the strike / quarantine bookkeeping, over
        one id space: the leader's pool and the hier group hop each get
        their own (process ids, or group ids at the root)."""
        cfg = self.cfg
        if not cfg.grad_integrity:
            return None
        return GradIntegrity(
            mad_threshold=cfg.integrity_mad_threshold,
            strike_limit=cfg.integrity_strike_limit,
            readmit_clean=cfg.integrity_readmit_clean,
            on_event=self._integrity_event)

    def _make_leader_aggregator(self):
        """The pool, screened by the integrity ledger before its sum, and
        under --shard-wire wrapped in the sharded updater. Under hier the
        root tier: it pools GROUP aggregates, with num_aggregate clamped
        to the group count (K-of-N a tier)."""
        cfg = self.cfg
        self._integrity = self._make_integrity()
        if cfg.sync_topology == "hier":
            plan = self.transport.plan
            return RootAggregator(
                plan.n_groups, cfg.grad_codec,
                staleness_limit=cfg.staleness_limit,
                staleness_decay=cfg.staleness_decay,
                num_aggregate=min(cfg.num_aggregate, plan.n_groups),
                on_event=self._hier_event, integrity=self._integrity)
        return self._wrap_shard_wire(StaleGradientAggregator(
            self.n, staleness_limit=cfg.staleness_limit,
            staleness_decay=cfg.staleness_decay,
            num_aggregate=cfg.num_aggregate, compress=self._wire_homo,
            codec=cfg.grad_codec, topk_frac=cfg.grad_topk_frac,
            integrity=self._integrity))

    def _wrap_shard_wire(self, agg):
        """--shard-wire: the pool (staleness, K-of-N, the screen) stays
        ``agg``; the update runs on the host a shard at a time and
        publishes the parameters a shard a key. The leader owns every
        shard."""
        if not self.cfg.shard_wire:
            return agg
        return updater_from_config(
            self.cfg, inner=agg, kv=self._kv, run_id=f"zw-{self.cfg.seed}",
            params=self._wire_tree(self.params), members=[0], me=0,
            n_shards=max(self.n, 2))

    # ---- the ops plane ----
    def _pump(self, snapshot: dict) -> None:
        """Registry counters up to a live snapshot's values (counters only
        rise; a key with no declared metric is skipped)."""
        for name, value in snapshot.items():
            try:
                delta = value - self.registry.get(name)
            except KeyError:
                continue
            if delta > 0:
                self.registry.inc(name, delta)

    def _pump_resilience_metrics(self) -> None:
        snap = {}
        if self.injector is not None:
            snap.update(self.injector.snapshot())
        if self._retrier is not None:
            snap.update(self._retrier.snapshot())
        self._pump(snap)

    def _pump_kvrep_metrics(self) -> None:
        self._pump(self._kvrep.snapshot())
        for name, value in self._kvrep.gauges().items():
            try:
                self.registry.set(name, value)
            except KeyError:
                continue

    def _integrity_event(self, kind: str, cid: int, step: int,
                         detail: str) -> None:
        """The quarantine's lifecycle: one line a transition (the JAX
        trainer's words). Strikes stay silent; the counters carry them."""
        if kind == "quarantine":
            print(f"INTEGRITY quarantine contributor {cid} at version "
                  f"{step} ({detail})", flush=True)
        elif kind == "readmit":
            print(f"INTEGRITY readmit contributor {cid} at version {step}",
                  flush=True)

    def _integrity_snapshot(self) -> dict:
        """The counters of every ledger this process runs (the leader's
        pool and the hier group hop), summed, and the transport's
        wire-digest failures."""
        snap: dict = {}
        for ledger in (self._integrity, self._group_integrity):
            if ledger is not None:
                for k, v in ledger.snapshot().items():
                    snap[k] = snap.get(k, 0) + v
        snap["wire_integrity_failures"] = self.transport.wire_stats()[
            "wire_integrity_failures"]
        return snap

    def _screens(self) -> bool:
        return self._integrity is not None or \
            self._group_integrity is not None

    def _pump_integrity_metrics(self) -> None:
        snap = self._integrity_snapshot()
        self.registry.set("integrity_quarantined",
                          float(snap.pop("integrity_quarantined", 0)))
        self._pump(snap)

    def _hier_telemetry(self) -> dict:
        """The hierarchy_* registry metrics up to the transport's and the
        root's counters; -> the JSONL's columns."""
        st = self.transport.stats
        counts = {"hierarchy_group_publishes": st["group_publishes"],
                  "hierarchy_failovers": st["failovers"]}
        hops = st["hops"]
        extra = {"hier_group_publishes": st["group_publishes"],
                 "hier_failovers": st["failovers"],
                 "hier_hop_giveups": st["hop_giveups"]}
        self.registry.set("hierarchy_groups",
                          float(self.transport.plan.n_groups))
        if self.leader:
            snap = self.aggregator.snapshot()
            hops += snap["hops"]
            self.registry.set("hierarchy_groups_healthy",
                              float(snap["groups_healthy"]))
            counts["hierarchy_degraded_steps"] = snap["degraded_steps"]
            extra["hier_groups_healthy"] = snap["groups_healthy"]
            extra["hier_degraded_steps"] = snap["degraded_steps"]
        counts["hierarchy_hops"] = hops
        self._pump(counts)
        return extra

    def _hier_event(self, kind: str, gid: int, step: int,
                    staleness: int) -> None:
        """The root's subtree lifecycle: one line a transition (the JAX
        trainer's words) and its counter."""
        if kind == "partition":
            self.registry.inc("hierarchy_partitions")
            print(f"HIER partition group {gid} at version {step} "
                  f"(silent {staleness})", flush=True)
        elif kind == "regraft":
            self.registry.inc("hierarchy_regrafts")
            print(f"HIER regraft group {gid} at version {step} "
                  f"staleness {staleness}", flush=True)

    def _health_status(self) -> dict:
        body = {"ok": True, "process_index": self.pid,
                "version": self.version, "leader": bool(self.leader),
                "role": "leader" if self.leader else "follower"}
        if self.election is not None:
            body["leader_epoch"] = self.election.epoch
            body["leader_owner"] = self.election.owner
        return body

    # ---- layouts between the port's parameters and the wire ----
    def _wire_leaves(self, tensors: Dict[str, torch.Tensor]
                     ) -> List[torch.Tensor]:
        """Parameter-shaped tensors in the JAX layout, in wire order, on
        their device."""
        return [leaf_layout(n, tensors[n].detach(), True).contiguous()
                for n in self.names]

    def _wire_tree(self, tensors: Dict[str, torch.Tensor]) -> dict:
        """Parameter-shaped tensors as the JAX-layout flax tree."""
        return nest(self._paths, self._wire_leaves(tensors))

    def _port_tensors(self, leaves) -> Dict[str, torch.Tensor]:
        """Wire-order JAX-layout leaves (numpy or tensors) -> name ->
        tensor in the port's layout on this process's device."""
        return {name: leaf_layout(name, self._on_device(a), False)
                .contiguous() for name, a in zip(self.names, leaves)}

    def _on_device(self, a) -> torch.Tensor:
        """A decoded leaf (numpy, maybe over an immutable buffer) or a
        tensor, on this process's device."""
        if isinstance(a, np.ndarray) and not a.flags.writeable:
            a = a.copy()
        return torch.as_tensor(a).to(self.device, non_blocking=True)

    @torch.no_grad()
    def _load_params(self, tree) -> None:
        for name, t in self._port_tensors(tree_flatten(tree)[0]).items():
            self.params[name].copy_(t)

    def _bs0(self) -> dict:
        """This process's BatchNorm statistics as the flax tree (no
        replica axis)."""
        buffers = dict(self.model.named_buffers())
        return nest(self._stat_paths,
                    [buffers[n].detach() for n in self._stat_names])

    # ---- checkpoint/resume (leader authority, sync-Trainer contract) ----
    def _checkpoint(self) -> None:
        # The leader's EF residual rides the checkpoint as extra state;
        # followers restart with a zero residual.
        extra_state = {"ef": self._ef.state_dict()} \
            if (self.cfg.ef and self._ef is not None) else None
        if self.cfg.shard_wire:
            # The sharded optimizer moments and step: without them a
            # resumed or promoted leader restarts them from zero.
            extra_state = dict(extra_state or {})
            extra_state["zero"] = self.aggregator.state_dict()
        extra = None
        if self.election is not None:
            # Which leadership epoch committed these weights.
            extra = {"leader_epoch": self.election.epoch,
                     "leader_pid": self.pid}
        ckpt.save_checkpoint(
            self.cfg.train_dir, self.version,
            state_to_jax(self.model, self.opt_state, self.version),
            config_json=self.cfg.to_json(), compress=self.cfg.compress_grad,
            codec_level=self.cfg.codec_level, extra_meta=extra,
            extra_state=extra_state)
        if self.injector is not None:
            self.injector.after_checkpoint(self.cfg.train_dir, self.version)
        if self.cfg.ckpt_keep > 0:
            ckpt.prune_checkpoints(self.cfg.train_dir, self.cfg.ckpt_keep)

    def _restore(self, tree: dict) -> None:
        self.opt_state, _ = state_from_jax(tree, self.model, self.opt_state)

    def _maybe_resume(self) -> bool:
        if ckpt.latest_step(self.cfg.train_dir) is None:
            return False
        got = ckpt.load_latest_valid(self.cfg.train_dir, self._restore)
        if got is None:
            return False
        _, meta, _, step = got
        self.version = int(meta["step"])
        extra = ckpt.load_extra_state(self.cfg.train_dir, step)
        if extra and "ef" in extra:
            self._ef = ErrorFeedback(clip=self.cfg.ef_clip)
            self._ef.load_state_dict(extra["ef"])
        if self.cfg.shard_wire:
            # Re-anchor the owned shards on the restored parameters, then
            # restore the sharded moments and step.
            self.aggregator.reset_params(self._wire_tree(self.params))
            if extra and "zero" in extra:
                self.aggregator.load_state_dict(extra["zero"])
            self._zw_ptr_version = -1      # publish the shards again
        # One contribution, one update a tick: the leader's sequence number
        # is the version, and its stream resumes where the run left it.
        self._seq = self.version
        self.train_loader.fast_forward(self.version)
        print(f"RESUME from {ckpt.checkpoint_path(self.cfg.train_dir, step)} "
              f"at step {self.version}", flush=True)
        return True

    # ---- wire codecs ----
    def _encode_grads(self, grads: Dict[str, torch.Tensor]):
        cfg = self.cfg
        leaves = self._wire_leaves(grads)
        if self._wire_homo:
            if cfg.ef and self._ef is None:
                self._ef = ErrorFeedback(clip=cfg.ef_clip)
            # Bucket k is encoded (and its EF updated) on the pool while
            # bucket k+1 comes off the device; payloads are bitwise the
            # same at every bucket size (leaf identity is the flat index).
            return nest(self._paths, encode_leaves(
                cfg.grad_codec, leaves, slice_id=self.pid, step=self._seq,
                frac=cfg.grad_topk_frac, ef=self._ef,
                bucket_bytes=(int(cfg.wire_bucket_mb * (1 << 20))
                              if self._wire_overlap else 0),
                pool=self._encode_pool()))
        if not self._wire_int8:
            # Device tensors: the channel copies each bucket (or leaf) to
            # the host after its own values are ready.
            return nest(self._paths, leaves)
        noise = None
        if self.noise_fn is not None:
            noise = [self.noise_fn(self.pid, self._seq, i,
                                   (padded_rows(l.numel()), LANES)).to(
                                       l.device) for i, l in enumerate(leaves)]
        return nest(self._paths, quantize_wire(
            leaves, cfg.seed * 31 + self._seq * self.n + self.pid, noise))

    def _encode_pool(self) -> Optional[ThreadPoolExecutor]:
        if self._enc_pool is None and self._wire_overlap \
                and self.cfg.wire_workers > 1:
            self._enc_pool = ThreadPoolExecutor(
                max_workers=self.cfg.wire_workers,
                thread_name_prefix="grad-enc")
        return self._enc_pool

    def _decode_grads(self, wire) -> Dict[str, torch.Tensor]:
        """A decoded raw / blosc / int8 wire tree -> f32 gradients in the
        port's layout on the device (int8 dequantized there)."""
        if not self._wire_int8:
            return self._port_tensors(tree_flatten(wire)[0])
        flat = []
        for enc, shape in zip(tree_flatten(wire, is_leaf=_is_quantized)[0],
                              self._jax_shapes):
            qt = QuantizedTensor(self._on_device(enc["v"]),
                                 self._on_device(enc["s"]), shape,
                                 int(np.prod(shape)))
            flat.append(dequantize_int8(qt))
        return self._port_tensors(flat)

    # ---- elastic role transitions ----
    def _promote(self, my_version: int) -> int:
        """Take up PS duty mid-run after winning an election: build the
        leader's machinery this process skipped at start, restore the
        optimizer state and the BatchNorm statistics from the newest
        valid checkpoint (the dead leader's momentum survives through its
        last commit; its parameters too when they are newer than this
        process's), move forward to the freshest canonical publish on the
        KV, and publish at once so the followers re-anchor."""
        cfg = self.cfg
        self._build_leader()
        self.version = my_version
        held = {k: v.detach().clone() for k, v in self.params.items()}
        got = ckpt.load_latest_valid(cfg.train_dir, self._restore)
        if got is not None and int(got[1]["step"]) > self.version:
            self.version = int(got[1]["step"])
        else:
            with torch.no_grad():
                for name, p in self.params.items():
                    p.copy_(held[name])
        # The canonical publish is usually ahead of any checkpoint
        # (publish_every against eval_freq): the freshest parameters win,
        # though the momentum then lags a few versions, the skew async
        # staleness already tolerates.
        got = self._fetch_canonical(self.version)
        if got is not None:
            self.version = got[0]
            self._load_params(got[1]["params"])
        if cfg.shard_wire:
            # The new updater re-anchors on the adopted parameters; the
            # dead leader's sharded moments survive through its last
            # checkpoint (the same lag as above).
            self.aggregator.reset_params(self._wire_tree(self.params))
            step = ckpt.latest_step(cfg.train_dir)
            extra = ckpt.load_extra_state(cfg.train_dir, step) \
                if step is not None else None
            if extra and "zero" in extra:
                self.aggregator.load_state_dict(extra["zero"])
            self._zw_ptr_version = -1      # a full shard publish below
        self.leader = True
        print(f"ELECTED async leader process {self.pid} epoch "
              f"{self.election.epoch} at version {self.version} "
              f"(election {self.elect_latency_s:.3f}s)", flush=True)
        self._publish_canonical()
        return self.version

    def _demote(self) -> None:
        self.leader = False
        print(f"DEPOSED async leader process {self.pid}: following epoch "
              f"{self.election.epoch} owner {self.election.owner}",
              flush=True)

    def _elastic_control(self, own_steps: int, my_version: int) -> int:
        """One control-plane beat a tick: the heartbeat, then the lease
        refresh and the membership fold (leader) or the staleness check
        (follower), and the campaign, promotion included, when the lease
        went stale. Returns the version this process's next contribution
        carries."""
        self.announcer.beat(own_steps)
        if self.leader:
            try:
                self.election.refresh(own_steps)
                self.membership.update(own_steps)
            except elastic.Deposed:
                self._demote()
            return self.version if self.leader else my_version
        if self.election.check() == "stale":
            t0 = time.monotonic()
            won = self.election.campaign()
            self.elect_latency_s = time.monotonic() - t0
            self.registry.inc("elections")
            if won:
                return self._promote(my_version)
        return my_version

    # ---- the two roles ----
    def _publish_canonical(self) -> None:
        t0 = time.monotonic()
        if self.cfg.shard_wire:
            # The parameters go out as zw shard keys, which each update
            # already published: a full publish only when the pointer lags
            # (start, resume, promotion). The channel carries the
            # BatchNorm statistics.
            if self._zw_ptr_version != self.version:
                self.aggregator.publish_full(self.version)
                self._zw_ptr_version = self.version
            payload = {"bs0": self._bs0()}
        else:
            payload = {"params": self._wire_tree(self.params),
                       "bs0": self._bs0()}
        self.transport.publish_params(self.version, payload)
        self.last_publish_s = time.monotonic() - t0

    def _zw_reader(self):
        """The reader-mode sharded updater of a process that owns no
        shard: ``fetch()`` assembles the newest consistent round."""
        if self._zw_rd is None:
            self._zw_rd = updater_from_config(
                self.cfg, inner=None, kv=self._kv,
                run_id=f"zw-{self.cfg.seed}",
                params=nest(self._paths, [np.zeros(s, np.float32)
                                          for s in self._jax_shapes]),
                members=[0], me=None, n_shards=max(self.n, 2))
        return self._zw_rd

    def _fetch_canonical(self, min_version: int = -1):
        """(version, {"params", "bs0"}) of the newest canonical publish
        above ``min_version``, else None. The pointer is read first, so a
        follower reads no payload it already holds. Under --shard-wire the
        parameters assemble from the shard keys and the statistics come
        from the channel (their version may lag the parameters', the skew
        of eval-only state)."""
        ch = self.transport.param_ch
        if self.cfg.shard_wire:
            got = self._zw_reader().fetch(min_version)
            if got is None:
                return None
            v = ch.latest_version()
            bs = ch.read(v) if v is not None else None
            return got[0], {"params": got[1],
                            "bs0": bs[1]["bs0"] if bs is not None
                            else self._bs0()}
        v = ch.latest_version()
        if v is None or v <= min_version:
            return None
        got = ch.read(v)
        return None if got is None else (got[0], got[1])

    def _compute_and_submit(self, version_used: int) -> dict:
        cfg = self.cfg
        with self.tracer.span("data_wait", step=self._seq + 1):
            x, y = self.train_loader.next_batch()
        with self.tracer.span("host_dispatch", step=self._seq + 1):
            grads, m = self.grad_fn(x, y, key=cfg.seed * 7919
                                    + self._seq * 13 + self.pid)
        self._seq += 1
        self.own_steps += 1
        if self.injector is not None:
            # --fault-spec grad_poison: this process's own gradients are
            # scaled before encode, so the corruption rides the real wire
            # and the leader's screen must catch it.
            scale = self.injector.poison_scale(self._seq)
            if scale is not None:
                grads = {k: g * scale for k, g in grads.items()}
        self.transport.submit_grads(self.pid, self._seq, version_used,
                                    self._encode_grads(grads))
        with self.tracer.span("device_sync", step=self._seq):
            loss, acc = torch.stack([m["loss"], m["accuracy"]]).tolist()
        return {"loss": loss, "acc": acc}

    def _leader_apply(self) -> int:
        """Pool new wire contributions and apply at most one update.
        Returns the number of contributions used (groups, under hier)."""
        if self._hier:
            # The root tier: one payload tree a group, with its (step,
            # wsum).
            for gid, step, wsum, tree in self.transport.poll_new_aggs():
                self.aggregator.submit_group(gid, step, wsum, tree)
        else:
            for s, step, wire in self.transport.poll_new_grads():
                if self._wire_homo:
                    self.aggregator.submit_encoded(s, step, wire)
                else:
                    self.aggregator.submit(s, step,
                                           self._decode_grads(wire))
        avg, pool = self.aggregator.collect(self.version)
        used = 0
        if avg is not None and pool["used"]:
            if self.cfg.shard_wire:
                # The sharded host update on the JAX-layout tree, its
                # shards published inside; the assembled tree comes back
                # into the port's parameters on the device.
                tree = avg if self._wire_homo else self._wire_tree(avg)
                self._load_params(self.aggregator.update_from(
                    tree, version=self.version + 1))
                self._zw_ptr_version = self.version + 1
            else:
                if self._wire_homo:
                    avg = self._port_tensors(
                        tree_flatten(avg, is_leaf=is_payload)[0])
                self.opt_state = self.opt.apply(self.params, self.opt_state,
                                                avg)
            self.version += 1
            self.applied += 1
            used = len(pool["used"])
            self.aggregator.consume(pool["used"])
            # publish_every > 1 trades follower freshness for publish
            # traffic; the final state is always published.
            if self.applied % max(self.cfg.publish_every, 1) == 0:
                self._publish_canonical()
            if self.cfg.eval_freq > 0 and \
                    self.version % self.cfg.eval_freq == 0:
                self._checkpoint()
        self.dropped_stale += self.aggregator.drop_older_than(self.version)
        return used

    def train(self):
        cfg = self.cfg
        my_version = 0
        try:
            if self.leader:
                if cfg.resume:
                    self._maybe_resume()
                # The start weights (fresh or resumed) become visible to
                # followers before anyone trains.
                self._publish_canonical()
            else:
                # Block on the leader's first publish (the reference
                # worker's first blocking fetch).
                deadline = time.monotonic() + 120.0
                while True:
                    got = self._fetch_canonical()
                    if got is not None:
                        my_version = got[0]
                        self._load_params(got[1]["params"])
                        break
                    if time.monotonic() > deadline:
                        raise TimeoutError("no initial params from leader")
                    time.sleep(0.05)
            # Safety valve for a follower whose leader dies before
            # set_done: a bounded loop.
            self._train_loop(cfg, my_version, cfg.max_steps * 50 + 100)
            if self.election is not None:
                # One summary line of the control plane a process.
                msnap = self.membership.snapshot()
                print(f"ELASTIC pid {self.pid} epoch {self.election.epoch} "
                      f"world {msnap['world_size']} membership_changes "
                      f"{msnap['membership_changes']} wins "
                      f"{self.election.stats['wins']}", flush=True)
            if self._hier:
                # One hierarchy summary line a process (the JAX
                # trainer's).
                st = self.transport.stats
                line = (f"HIERARCHY pid {self.pid} gid {self.transport.gid} "
                        f"aggregator {int(self.transport.is_aggregator)} "
                        f"hops {st['hops']} publishes "
                        f"{st['group_publishes']} failovers "
                        f"{st['failovers']} giveups {st['hop_giveups']}")
                if self.leader:
                    root = self.aggregator.snapshot()
                    line += (f" partitions {root['partitions']} regrafts "
                             f"{root['regrafts']} degraded_steps "
                             f"{root['degraded_steps']} groups_healthy "
                             f"{root['groups_healthy']}")
                print(line, flush=True)
            if self._screens():
                # One summary line a screening process (the JAX
                # trainer's).
                s = self._integrity_snapshot()
                print(f"INTEGRITY pid {self.pid} screen_rejects "
                      f"{s.get('integrity_screen_rejects', 0)} "
                      f"outlier_rejects "
                      f"{s.get('integrity_outlier_rejects', 0)} strikes "
                      f"{s.get('integrity_strikes', 0)} quarantines "
                      f"{s.get('integrity_quarantines', 0)} readmissions "
                      f"{s.get('integrity_readmissions', 0)} wire_failures "
                      f"{s.get('wire_integrity_failures', 0)}", flush=True)
        finally:
            if self.announcer is not None:
                try:
                    # Graceful leave: the leader evicts on the
                    # announcement, not at the heartbeat deadline.
                    self.announcer.leave()
                except Exception:
                    pass            # the store may already be gone
            if self.exporter is not None:
                self.exporter.stop()
            self.metrics.close()
            if cfg.trace_file:
                path = cfg.trace_file
                if self.pid > 0:
                    path = f"{path}.p{self.pid}"
                self.tracer.write_chrome_trace(path)
            set_default_tracer(self._prev_tracer)
        return self.params

    def _train_loop(self, cfg, my_version: int, max_own: int) -> None:
        own_steps = 0
        while own_steps < max_own:
            t0 = time.monotonic()
            if self.injector is not None:
                # Keyed on this process's own ticks: a follower has no
                # global step.
                self.injector.maybe_crash(own_steps + 1)
                self.injector.maybe_kill_leader(own_steps + 1,
                                                is_leader=self.leader)
            if self.election is not None:
                my_version = self._elastic_control(own_steps, my_version)
            if self.transport.done() is not None and not self.leader:
                break
            if self.leader and self.version >= cfg.max_steps:
                break
            if self.leader:
                # The leader's parameters are canonical, and its
                # contributions carry the true current version.
                my_version = self.version
            elif own_steps % self.fetch_every == 0:
                got = self._fetch_canonical(my_version)
                if got is not None:
                    my_version = got[0]
                    self._load_params(got[1]["params"])
            m = self._compute_and_submit(my_version)
            own_steps += 1
            if self._hier:
                # Every process pumps: the group lease stays fresh, and
                # its holder drains the member channels and publishes the
                # group's aggregate up (after the submit above, so it
                # pools its own contribution of this round).
                before = self.transport.stats["failovers"]
                self.transport.pump(my_version)
                if self.transport.stats["failovers"] > before:
                    print(f"HIER failover: process {self.pid} adopted "
                          f"aggregator role for group {self.transport.gid} "
                          f"at own step {own_steps}", flush=True)
            used = self._leader_apply() if self.leader else 0
            if self._claim_pending:
                # The initial leader claims epoch 1 once its first tick
                # (kernel builds and loads included) is behind it.
                self._claim_pending = False
                self.election.claim_initial()
            step_for_log = self.version if self.leader else own_steps
            self.registry.inc("train_steps")
            self.registry.observe("train_step_latency_s",
                                  time.monotonic() - t0)
            if step_for_log and step_for_log % cfg.log_every == 0:
                self._registry_step(step_for_log, m["loss"], t0)
                wire = self.transport.wire_stats()
                extra = {}
                if self.election is not None:
                    extra["leader_epoch"] = self.election.epoch
                if self._hier:
                    extra.update(self._hier_telemetry())
                if self._screens():
                    isnap = self._integrity_snapshot()
                    # Schema gate: the integrity columns appear with a
                    # fault plane, or once a screen or a digest fired.
                    if self.injector is not None or any(isnap.values()):
                        extra.update(isnap)
                if self.injector is not None:
                    extra.update(self.injector.snapshot())
                if self._retrier is not None:
                    s = self._retrier.snapshot()
                    # Schema gate: the resilience columns appear with a
                    # fault plane, or once the retry plane absorbed an
                    # error.
                    if self.injector is not None or s["kv_retries"] or \
                            s["kv_giveups"]:
                        extra.update(s)
                self.metrics.log_step(
                    step_for_log, 0, loss=m["loss"], acc=m["acc"],
                    participating=float(used),
                    step_time=time.monotonic() - t0, data_time=0.0,
                    applied=self.applied, dropped_stale=self.dropped_stale,
                    wire_bytes_out=wire["wire_bytes_out"],
                    wire_bytes_in=wire["wire_bytes_in"],
                    publish_s=round(self.last_publish_s, 4), **extra)
        if self.leader:
            if cfg.eval_freq > 0 and self.version % cfg.eval_freq != 0:
                self._checkpoint()
            # The final state, visible to every process whatever
            # publish_every (evaluate() and late followers read it).
            self._publish_canonical()
            self.transport.set_done(self.version)

    def _registry_step(self, step: int, loss: float, t0: float) -> None:
        """A logged step's gauges: step, loss, time, memory and, with
        --elastic, the epoch, the world and the membership changes."""
        r = self.registry
        r.set("train_step", float(step))
        r.set("train_loss", float(loss))
        r.set("train_step_time_s", time.monotonic() - t0)
        r.set("host_rss_bytes", float(host_rss_bytes()))
        for k, v in device_memory_record(self.device).items():
            r.set(k, float(v))
        if self.election is not None:
            r.set("leader_epoch", float(self.election.epoch))
            snap = self.membership.snapshot()
            r.set("world_size", float(snap["world_size"] or self.n))
            delta = snap["membership_changes"] - r.get("membership_changes")
            if delta > 0:
                r.inc("membership_changes", delta)

    @property
    def fetch_every(self) -> int:
        return max(self.cfg.fetch_every, 1)

    def evaluate(self, max_batches: Optional[int] = None) -> dict:
        """Every process scores the canonical state, the parameters and
        the leader's BatchNorm statistics of the newest publish, so all
        FINAL lines agree; its own state is put back after."""
        got = self._fetch_canonical()
        held = None
        if got is not None:
            held = {k: v.detach().clone()
                    for k, v in self.model.state_dict().items()}
            self._load_params(got[1]["params"])
            buffers = dict(self.model.named_buffers())
            with torch.no_grad():
                for name, a in zip(self._stat_names,
                                   tree_flatten(got[1]["bs0"])[0]):
                    buffers[name].copy_(self._on_device(a))
        try:
            return accumulate_eval(self.eval_fn, self.test_loader.epoch(0),
                                   max_batches)
        finally:
            if held is not None:
                with torch.no_grad():
                    for k, v in self.model.state_dict().items():
                        v.copy_(held[k])

    def leave(self, timeout_s: float = 300.0) -> None:
        """Mark this process done with the store. Process 0, which serves
        the TCPStore whatever process leads, waits for every other
        process's mark before it returns, so no process loses the store
        while it reads the final state; it does not wait for a process
        the membership evicted (dead without leaving, a ``leader_kill``)."""
        self._kv.set(f"{self.run_id}/aexit/{self.pid}", "1")
        self.transport.close()
        if self._enc_pool is not None:
            self._enc_pool.shutdown(wait=True)
            self._enc_pool = None
        if self.pid != 0:
            return
        deadline = time.monotonic() + timeout_s
        for p in range(1, self.n):
            while self._kv.get(f"{self.run_id}/aexit/{p}") is None \
                    and not (self.membership is not None
                             and self.membership.evicted(p)):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"process {p} did not leave within "
                                       f"{timeout_s} s")
                time.sleep(0.05)
