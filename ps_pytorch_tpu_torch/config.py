"""Typed configuration of the PyTorch port.

The same dataclass as the JAX package's ``config.py``: every field keeps its
name and default, so ``to_json``/``from_json`` read and write the same keys
and a config from either package loads in the other. The port runs some
slices of the system (synchronous data-parallel CNN training, K-of-N
included, one process a replica, with cross-replica BatchNorm statistics,
ZeRO-1, recomputation, the loader's worker pool, the fault plane,
heartbeats and auto-resume, its checkpoints and evaluator; asynchronous
stale-gradient training with its codecs, in one process or one process a
slice over the KV wire, with the sharded wire update (``--shard-wire``),
the hierarchical topology (``--sync-topology hier``) and, across
processes, the gradient integrity screen and the exporter;
the KV retry plane; the elastic control plane
(leader lease, elections, membership) and the quorum-replicated KV under
the CNN trainer and the asynchronous one across processes; and the ops
plane of the synchronous and LM trainers, see ROADMAP.md), so a field it
does not run
raises ``ValueError`` when it is set to anything but its default: it is
never silently ignored. The LM fields run for ``lm_parallelism="sp"`` on
one device (``runtime/lm_trainer.py``), with its checkpoints, remat and
the fault plane's crash and checkpoint corruption.

``donate`` takes ``true`` and ``false`` alike: the JAX step donates its
input buffers to XLA, while the port's step updates the parameters, the
optimizer state and the BatchNorm statistics in place, so neither value
changes the port's arithmetic or its memory.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Optional


@dataclass
class TrainConfig:
    # -- model / data --
    network: str = "LeNet"
    dataset: str = "MNIST"
    batch_size: int = 128
    test_batch_size: int = 1000
    data_dir: str = "./data"
    num_classes: int = 0             # 0 = infer from dataset
    loader_workers: int = 1

    # -- optimization --
    optimizer: str = "sgd"
    lr: float = 0.01
    lr_schedule: str = "constant"    # constant | step | cosine
    lr_warmup_steps: int = 0
    lr_decay_steps: int = 0
    lr_decay_factor: float = 0.1
    momentum: float = 0.5
    weight_decay: float = 0.0
    nesterov: bool = False
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_eps: float = 1e-8
    amsgrad: bool = False

    # -- run control --
    epochs: int = 1
    max_steps: int = 1000
    eval_freq: int = 50              # checkpoint period in the JAX trainer
    train_dir: str = "./train_dir"
    resume: bool = True
    seed: int = 42

    # -- parallelism --
    mode: str = "sync"
    num_aggregate: int = 0
    kill_threshold: float = 0.0
    staleness_limit: int = 4
    staleness_decay: float = 0.0
    async_slices: int = 2
    fetch_every: int = 1
    publish_every: int = 1
    data_axis: int = 0
    model_axis: int = 1
    sync_batchnorm: bool = False
    shard_update: bool = False
    shard_wire: bool = False

    # -- hierarchical sync --
    sync_topology: str = "flat"
    sync_group_size: int = 0
    sync_intra_every: int = 1
    sync_inter_every: int = 1
    hier_hop_retries: int = 3

    # -- numerics --
    compute_dtype: str = "bfloat16"  # params stay float32
    device_normalize: bool = True    # loaders ship uint8; the step normalizes
    fused_optimizer: bool = False    # hand-written SGD kernel (ops/fused_sgd.py)
    conv_impl: str = "xla"           # xla | pallas | pallas_im2col (ops/conv3x3.py)
    donate: bool = True
    remat: bool = False

    # -- compression --
    compress_grad: bool = False
    codec_level: int = 3
    grad_codec: str = "blosc"
    grad_topk_frac: float = 0.01
    ef: bool = False
    ef_clip: float = 0.0

    # -- overlapped gradient wire --
    wire_bucket_mb: float = 4.0
    wire_workers: int = 4

    # -- LM surface --
    lm_vocab: int = 256
    lm_d_model: int = 128
    lm_layers: int = 2
    lm_heads: int = 4
    lm_seq_len: int = 1024
    lm_corpus_tokens: int = 1_000_000
    lm_corpus_file: str = ""
    lm_parallelism: str = "sp"
    lm_attention: str = "auto"
    lm_model_axis: int = 0
    lm_microbatches: int = 4
    lm_experts: int = 8
    lm_moe_top_k: int = 1

    # -- fault injection --
    inject_step_delay: float = 0.0
    inject_delay_process: int = -1

    # -- resilience --
    fault_spec: str = ""
    heartbeat_interval_s: float = 0.0
    heartbeat_timeout_s: float = 0.0
    kv_retry_attempts: int = 5
    kv_retry_base_s: float = 0.05
    kv_retry_budget: int = 1000
    kv_replicas: str = ""
    kv_quorum: int = 0
    kv_resync_s: float = 1.0
    ckpt_keep: int = 0
    auto_resume: int = 0
    leader_lease_s: float = 0.0

    # -- gradient integrity --
    grad_integrity: bool = True
    integrity_mad_threshold: float = 6.0
    integrity_strike_limit: int = 3
    integrity_readmit_clean: int = 3

    # -- elastic control plane --
    elastic: bool = False
    elastic_leader: int = 0

    # -- serving --
    serve_slots: int = 8
    serve_max_queue: int = 64
    serve_reload_s: float = 10.0
    serve_port: int = 8300
    serve_host: str = "127.0.0.1"
    serve_deadline_s: float = 30.0
    serve_max_new: int = 128
    slo_spec: str = ""
    reqtrace_keep: int = 256
    reqtrace_sample: float = 0.05
    serve_max_body_bytes: int = 1048576
    serve_kv_dir: str = ""
    serve_fleet: str = "fleet"
    serve_replica_id: int = 0
    serve_advertise: str = ""

    # -- logging / profiling / telemetry --
    log_every: int = 1
    metrics_file: str = ""
    profile_dir: str = ""
    profile_steps: str = "10-12"
    trace_file: str = ""
    timeline_file: str = ""

    # -- live ops plane --
    metrics_port: int = 0
    health_spec: str = ""
    flight_file: str = ""

    def __post_init__(self) -> None:
        from ps_pytorch_tpu_torch.data.datasets import DATASET_SHAPES
        if self.dataset == "ImageNet":
            raise ValueError(
                "dataset 'ImageNet' is not ported yet (ROADMAP.md): its "
                "files are not in the repo and its parser is not ported; "
                "synthetic_imagenet_rrc runs the same 256 -> 224 px "
                "random-resized-crop path")
        if self.dataset not in DATASET_SHAPES:
            raise ValueError(
                f"dataset {self.dataset!r} is not ported yet (ROADMAP.md); "
                f"choose from {sorted(DATASET_SHAPES)}")
        if self.num_classes == 0:
            self.num_classes = DATASET_SHAPES[self.dataset][3]
        if self.mode not in ("sync", "kofn", "async"):
            raise ValueError(f"unknown mode {self.mode!r}")
        if self.optimizer not in ("sgd", "adam"):
            raise ValueError(f"unknown optimizer {self.optimizer!r}")
        if self.lr_schedule not in ("constant", "step", "cosine"):
            raise ValueError(f"unknown lr_schedule {self.lr_schedule!r} "
                             "(constant | step | cosine)")
        if self.conv_impl not in ("xla", "pallas", "pallas_im2col"):
            raise ValueError(f"unknown conv_impl {self.conv_impl!r} "
                             "(xla | pallas | pallas_im2col)")
        if self.compute_dtype not in ("float32", "bfloat16", "float16"):
            raise ValueError(f"unknown compute_dtype {self.compute_dtype!r}")
        # The hand-written kernels take f32 and bf16. float16 runs where no
        # kernel is on the path: --conv-impl xla, and the LM with full
        # attention (lm_attention "auto" is full on the one device the LM
        # runs on, runtime/lm_trainer.py).
        if self.compute_dtype == "float16" and (
                self.conv_impl != "xla" and self.network not in LM_NETWORKS
                or self.network in LM_NETWORKS
                and self.lm_attention == "flash"):
            raise ValueError(
                "compute_dtype='float16' with a hand-written kernel on the "
                f"path (conv_impl={self.conv_impl!r}, lm_attention="
                f"{self.lm_attention!r}) is not ported yet (ROADMAP.md): the "
                "kernels take float32 and bfloat16; use --conv-impl xla or "
                "--lm-attention full")
        if self.loader_workers < 0:
            raise ValueError(f"loader_workers={self.loader_workers} "
                             "(must be >= 0; 0 = one per CPU)")
        if self.nesterov and (self.momentum <= 0):
            raise ValueError("Nesterov momentum requires a momentum")
        if self.fault_spec:
            # Parsed here: a typo'd spec fails at config time, not when
            # the fault would have fired.
            from ps_pytorch_tpu_torch.resilience.faults import (
                parse_fault_spec,
            )
            for fault in parse_fault_spec(self.fault_spec):
                if self.mode != "async" and \
                        fault["kind"] in ASYNC_FAULT_KINDS:
                    raise ValueError(
                        f"fault kind {fault['kind']!r} with mode="
                        f"{self.mode!r} is not ported yet (ROADMAP.md): it "
                        f"needs {ASYNC_FAULT_KINDS[fault['kind']]}; it runs "
                        f"with --mode async across processes")
                if self.mode == "async" and \
                        fault["kind"] in SYNC_FAULT_KINDS:
                    raise ValueError(
                        f"fault kind {fault['kind']!r} with mode='async' is "
                        f"not ported yet (ROADMAP.md): it needs "
                        f"{SYNC_FAULT_KINDS[fault['kind']]}; it runs with "
                        f"--mode sync or kofn")
        self._check_serving()
        if self.lm_parallelism not in ("sp", "tp", "pp", "ep"):
            raise ValueError(f"unknown lm_parallelism "
                             f"{self.lm_parallelism!r} (sp | tp | pp | ep)")
        if self.lm_attention not in ("auto", "full", "flash"):
            raise ValueError(f"unknown lm_attention "
                             f"{self.lm_attention!r} (auto | full | flash)")
        if self.lm_parallelism != "sp":
            raise ValueError(f"lm_parallelism={self.lm_parallelism!r} is not "
                             "ported yet (ROADMAP.md); only sp on one "
                             "device runs")
        if self.mode != "sync" and self.network in LM_NETWORKS:
            raise ValueError(f"mode={self.mode!r} for {self.network} is not "
                             "ported yet (ROADMAP.md); the LM trains in "
                             "mode 'sync' on one device")
        if self.network in LM_NETWORKS:
            # The JAX LMTrainer reads remat and the fault plane's
            # replica_crash and ckpt_corrupt, and none of the other
            # step options or control fields.
            for name in SYNC_ONLY_FIELDS + CONTROL_FIELDS + (
                    "loader_workers",):
                if name in LM_FIELDS:
                    continue
                if getattr(self, name) != _default(name):
                    raise ValueError(
                        f"{name}={getattr(self, name)!r} for {self.network} "
                        "is not ported yet (ROADMAP.md); the CNN trainer "
                        "runs it")
            if self.fault_spec:
                from ps_pytorch_tpu_torch.resilience.faults import (
                    parse_fault_spec,
                )
                for fault in parse_fault_spec(self.fault_spec):
                    if fault["kind"] not in LM_FAULT_KINDS \
                            + SERVING_FAULT_KINDS:
                        raise ValueError(
                            f"fault kind {fault['kind']!r} for "
                            f"{self.network} is not ported yet "
                            f"(ROADMAP.md): the LM trainer fires "
                            f"{' and '.join(LM_FAULT_KINDS)}; the CNN "
                            f"trainer runs it")
        from ps_pytorch_tpu_torch.compression.codecs import (
            EF_GRAD_CODECS, GRAD_CODECS, require_codec,
        )
        require_codec("grad_codec", self.grad_codec, GRAD_CODECS)
        if not (0.0 < self.grad_topk_frac <= 1.0):
            raise ValueError(f"grad_topk_frac={self.grad_topk_frac} "
                             "(must be in (0, 1])")
        if self.ef and self.grad_codec not in EF_GRAD_CODECS:
            raise ValueError(
                f"--ef requires a lossy homomorphic grad_codec "
                f"({' | '.join(EF_GRAD_CODECS)}), got {self.grad_codec!r}")
        if self.wire_bucket_mb < 0:
            raise ValueError(f"wire_bucket_mb={self.wire_bucket_mb} "
                             "(must be >= 0; 0 = blocking wire)")
        if self.wire_workers < 0:
            raise ValueError(f"wire_workers={self.wire_workers} "
                             "(must be >= 0; <=1 = no pipelining)")
        if self.ef_clip < 0:
            raise ValueError(f"ef_clip={self.ef_clip} (must be >= 0; "
                             "0 = unclamped residual)")
        if self.health_spec:
            # A typo'd watchdog fails here, not during the incident it was
            # meant to catch.
            from ps_pytorch_tpu_torch.telemetry.health import (
                parse_health_spec,
            )
            parse_health_spec(self.health_spec)
        if self.metrics_port < 0:
            raise ValueError(f"metrics_port={self.metrics_port} "
                             "(must be >= 0; 0 = exporter off)")
        if self.kv_retry_attempts < 1:
            raise ValueError(f"kv_retry_attempts={self.kv_retry_attempts} "
                             "(must be >= 1; 1 = no retries)")
        for name in ("heartbeat_interval_s", "heartbeat_timeout_s",
                     "kv_retry_base_s"):
            if getattr(self, name) < 0:
                raise ValueError(f"{name} must be >= 0")
        if 0 < self.heartbeat_timeout_s <= self.heartbeat_interval_s:
            # A deadline at or below the beat period can never be met:
            # every process would look dead between its own beats.
            raise ValueError(
                f"heartbeat_timeout_s={self.heartbeat_timeout_s} <= "
                f"heartbeat_interval_s={self.heartbeat_interval_s}: a beat "
                f"can never land inside its own deadline, so liveness "
                f"flaps instead of detecting death. Set heartbeat_timeout_s "
                f"> heartbeat_interval_s (0 = 3x interval), or 0 for the "
                f"default.")
        if 0 < self.heartbeat_timeout_s <= self.leader_lease_s:
            # The same inversion one layer up: the leader beats at the
            # lease cadence, so this deadline evicts a healthy leader.
            raise ValueError(
                f"heartbeat_timeout_s={self.heartbeat_timeout_s} <= "
                f"leader_lease_s={self.leader_lease_s}: the leader beats "
                f"at the lease cadence, so this deadline evicts a healthy "
                f"leader between refreshes. Set heartbeat_timeout_s > "
                f"leader_lease_s (0 = derived default).")
        if self.kv_replicas:
            # The backend grammar and the quorum overlap, before anything
            # is wired under the trainers.
            from ps_pytorch_tpu_torch.runtime.kvrep import (
                parse_backend_specs,
            )
            n_rep = len(parse_backend_specs(self.kv_replicas))
            majority = n_rep // 2 + 1
            if self.kv_quorum and not majority <= self.kv_quorum <= n_rep:
                raise ValueError(
                    f"kv_quorum={self.kv_quorum} is unsafe for {n_rep} "
                    f"replicas: any two quorums must overlap, so it must "
                    f"be in [{majority}, {n_rep}] (0 = majority).")
        if self.kv_quorum < 0:
            raise ValueError(f"kv_quorum={self.kv_quorum} (must be >= 0; "
                             "0 = majority)")
        if self.kv_resync_s <= 0:
            raise ValueError(f"kv_resync_s={self.kv_resync_s} "
                             "(must be > 0)")
        if self.ckpt_keep < 0 or self.kv_retry_budget < 0 or \
                self.auto_resume < 0:
            raise ValueError("ckpt_keep / kv_retry_budget / auto_resume "
                             "must be >= 0")
        if self.leader_lease_s < 0:
            raise ValueError(f"leader_lease_s={self.leader_lease_s} "
                             "(must be >= 0; 0 = lease off)")
        if self.elastic and self.leader_lease_s <= 0:
            # The election is driven by the lease going stale: without a
            # lease there is no death signal to campaign on.
            raise ValueError("elastic=True requires leader_lease_s > 0 "
                             "(the lease is the failure detector)")
        if self.elastic_leader < 0:
            raise ValueError(f"elastic_leader={self.elastic_leader} "
                             "(must be >= 0)")
        if self.integrity_mad_threshold <= 0:
            raise ValueError(
                f"integrity_mad_threshold={self.integrity_mad_threshold} "
                "(must be > 0)")
        if self.integrity_strike_limit < 1 or self.integrity_readmit_clean < 1:
            raise ValueError("integrity_strike_limit / "
                             "integrity_readmit_clean must be >= 1")
        if self.sync_topology not in ("flat", "hier"):
            raise ValueError(f"unknown sync_topology {self.sync_topology!r} "
                             "(flat | hier)")
        if self.sync_topology == "hier":
            # The group aggregators sum member payloads in the compressed
            # domain and re-encode once a hop: only the homomorphic codecs
            # support that (the JAX package's check and message).
            from ps_pytorch_tpu_torch.compression.codecs import (
                HOMOMORPHIC_GRAD_CODECS,
            )
            if not self.compress_grad or \
                    self.grad_codec not in HOMOMORPHIC_GRAD_CODECS:
                raise ValueError(
                    "sync_topology=hier requires compress_grad=True and a "
                    f"homomorphic grad_codec "
                    f"({' | '.join(HOMOMORPHIC_GRAD_CODECS)}), got "
                    f"compress_grad={self.compress_grad} "
                    f"grad_codec={self.grad_codec!r}")
        if self.sync_group_size < 0:
            raise ValueError(f"sync_group_size={self.sync_group_size} "
                             "(must be >= 0; 0 = auto)")
        if self.sync_intra_every < 1 or self.sync_inter_every < 1:
            raise ValueError("sync_intra_every / sync_inter_every must be "
                             ">= 1")
        if self.hier_hop_retries < 1:
            raise ValueError(f"hier_hop_retries={self.hier_hop_retries} "
                             "(must be >= 1; 1 = no retries)")
        if self.shard_wire:
            # --shard-wire holds a bitwise guarantee (sharded update ==
            # replicated update, exactly): every combination that cannot
            # certify it is refused, with the JAX package's message.
            if self.shard_update:
                raise ValueError(
                    "--shard-wire and --shard-update are two homes for the "
                    "SAME ZeRO-1 state split: across KV replicas vs across "
                    "the in-mesh data axis. Nesting them would shard "
                    "already-sharded optimizer state; pick one.")
            if self.mode != "async":
                raise ValueError(
                    f"--shard-wire shards the weight update on the async KV "
                    f"plane; mode={self.mode!r} has no KV update path. Use "
                    f"--mode async, or --shard-update for the in-mesh "
                    f"(sync/kofn) form.")
            if self.sync_topology == "hier":
                raise ValueError(
                    "--shard-wire requires sync_topology=flat: hierarchical "
                    "multi-hop re-weighting aggregates per tier, so the "
                    "per-shard update could not be certified bitwise-equal "
                    "to the replicated update.")
            if self.compress_grad and self.grad_codec == "int8":
                raise ValueError(
                    "--shard-wire cannot use grad_codec=int8: its on-device "
                    "Pallas dequantize keeps per-contributor payloads "
                    "device-resident, while the sharded update is applied "
                    "host-side. Use blosc or a homomorphic codec "
                    "(int8lat | topk | randk); --ef composes fine.")
            if self.lr_schedule != "constant":
                raise ValueError(
                    f"--shard-wire supports lr_schedule=constant only (got "
                    f"{self.lr_schedule!r}): the host-side sharded optimizer "
                    f"pins the float32 step size; a jitted schedule would "
                    f"break the bitwise sharded==replicated guarantee.")
        if self.mode == "async" and \
                self.publish_every > max(self.staleness_limit, 1):
            # Followers see only published versions: a publish gap wider
            # than the staleness window makes every follower gradient
            # stale for good.
            raise ValueError(
                f"publish_every={self.publish_every} > "
                f"staleness_limit={self.staleness_limit}: followers could "
                f"never contribute a fresh-enough gradient")
        parse_profile_steps(self.profile_steps)
        # A field inert in the JAX trainer of this mode raises here rather
        # than being ignored. Asynchronous training runs in one process
        # (MultiSliceTrainer) unless the launch contract asks for several
        # (AsyncTrainer, one process a slice), which reads the wire's
        # publish period, writes the trace of the wire's spans, serves the
        # exporter, screens its pool (the integrity fields) and runs the
        # control plane: the fault plane, the replicated KV and, with
        # --elastic, the lease, the initial leader and the heartbeats of
        # the membership (the lease's interval also with --sync-topology
        # hier, for the group lease). --shard-wire and the hierarchical
        # topology run under --mode async in one process and across
        # processes.
        wire = self.mode == "async" and several_processes()
        async_runs = WIRE_FIELDS + INTEGRITY_FIELDS + (
            "trace_file", "metrics_port", "fault_spec", "kv_replicas",
            "kv_quorum", "kv_resync_s", "elastic")
        if self.elastic:
            async_runs += ELASTIC_ONLY_FIELDS
        elif self.sync_topology == "hier":
            # The group aggregator's lease interval (the JAX trainer's
            # ``cfg.leader_lease_s or 1.0``), with or without --elastic.
            async_runs += ("leader_lease_s",)
        inert = {"sync": ASYNC_ONLY_FIELDS + WIRE_FIELDS + INTEGRITY_FIELDS
                 + ("num_aggregate",),
                 "kofn": ASYNC_ONLY_FIELDS + WIRE_FIELDS + INTEGRITY_FIELDS,
                 "async": tuple(
                     f for f in SYNC_ONLY_FIELDS + CONTROL_FIELDS
                     + OPS_FIELDS + WIRE_FIELDS + INTEGRITY_FIELDS
                     if not (wire and f in async_runs))
                 }[self.mode]
        for name in inert:
            if name == "fault_spec" and self._serving_faults_only():
                continue        # serve.py's kinds: no trainer reads them
            if getattr(self, name) != _default(name):
                runs = ("--mode kofn or async" if name == "num_aggregate"
                        else "--mode sync or kofn" if name in SYNC_ONLY_FIELDS
                        else "--mode async only" if name in ASYNC_ONLY_FIELDS
                        else "--mode async across processes"
                        if name in WIRE_FIELDS + INTEGRITY_FIELDS
                        else "--mode sync or kofn, the LM, and --mode async "
                        "across processes"
                        if name in ("trace_file", "metrics_port")
                        else "--mode sync or kofn, and --mode async across "
                        "processes with --elastic or --sync-topology hier"
                        if name == "leader_lease_s"
                        else "--mode sync or kofn, and --mode async across "
                        "processes with --elastic"
                        if name in ELASTIC_ONLY_FIELDS
                        else "--mode sync or kofn, and --mode async across "
                        "processes" if name in CONTROL_FIELDS
                        else "--mode sync or kofn, and the LM")
                raise ValueError(
                    f"{name}={getattr(self, name)!r} with mode="
                    f"{self.mode!r} is not ported yet (ROADMAP.md); it runs "
                    f"with {runs}")
        for name in sorted(set(TrainConfig.__dataclass_fields__)
                           - PORTED_FIELDS):
            if getattr(self, name) != _default(name):
                raise ValueError(
                    f"{name}={getattr(self, name)!r} is not ported yet "
                    f"(ROADMAP.md); leave it at its default "
                    f"{_default(name)!r}")

    def _serving_faults_only(self) -> bool:
        from ps_pytorch_tpu_torch.resilience.faults import parse_fault_spec
        return all(f["kind"] in SERVING_FAULT_KINDS
                   for f in parse_fault_spec(self.fault_spec))

    def _check_serving(self) -> None:
        """The serving fields (``serve.py``), the JAX checks and
        messages. No trainer reads them."""
        if self.serve_slots < 1:
            raise ValueError(f"serve_slots={self.serve_slots} (must be >= 1)")
        if self.serve_max_queue < 1:
            raise ValueError(f"serve_max_queue={self.serve_max_queue} "
                             "(must be >= 1)")
        if self.serve_max_new < 1:
            raise ValueError(f"serve_max_new={self.serve_max_new} "
                             "(must be >= 1)")
        if self.serve_reload_s < 0 or self.serve_deadline_s <= 0:
            raise ValueError("serve_reload_s must be >= 0 and "
                             "serve_deadline_s > 0")
        if self.serve_port < 0:
            raise ValueError(f"serve_port={self.serve_port} "
                             "(must be >= 0; 0 = ephemeral)")
        if self.serve_max_body_bytes < 1:
            raise ValueError(f"serve_max_body_bytes="
                             f"{self.serve_max_body_bytes} (must be >= 1)")
        if self.serve_replica_id < 0:
            raise ValueError(f"serve_replica_id={self.serve_replica_id} "
                             "(must be >= 0)")
        if self.slo_spec:
            from ps_pytorch_tpu_torch.telemetry.slo import parse_slo_spec
            parse_slo_spec(self.slo_spec)
        if self.reqtrace_keep < 0:
            raise ValueError(f"reqtrace_keep={self.reqtrace_keep} "
                             "(must be >= 0; 0 = tracing off)")
        if not 0.0 <= self.reqtrace_sample <= 1.0:
            raise ValueError(f"reqtrace_sample={self.reqtrace_sample} "
                             "(must be in [0, 1])")

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "TrainConfig":
        return cls(**json.loads(s))


LM_NETWORKS = ("TransformerLM", "MoETransformerLM")


def _default(name: str):
    return TrainConfig.__dataclass_fields__[name].default


# Fields that only the asynchronous trainer reads. ``num_aggregate`` is
# read by it too (the freshest K slices) and by K-of-N (the fastest K
# replicas).
# The hierarchical topology (``parallel/hierarchy.py``): both asynchronous
# trainers read it, in one process and across processes; the synchronous
# trainers ignore it in the JAX package, so the port refuses it there.
HIER_FIELDS = ("sync_topology", "sync_group_size", "sync_intra_every",
               "sync_inter_every", "hier_hop_retries")
ASYNC_ONLY_FIELDS = ("async_slices", "fetch_every",
                     "staleness_limit", "staleness_decay", "grad_codec",
                     "grad_topk_frac", "ef", "ef_clip", "wire_bucket_mb",
                     "wire_workers") + HIER_FIELDS
# Fields that only the synchronous CNN trainer (sync and kofn) reads: the
# straggler deadline and the injected straggler, the step's options
# (cross-replica BatchNorm statistics, ZeRO-1, recomputation) and the
# auto-resume loop.
SYNC_ONLY_FIELDS = ("kill_threshold", "inject_step_delay",
                    "inject_delay_process", "sync_batchnorm",
                    "shard_update", "remat", "auto_resume")
# The control plane: the fault plane, heartbeats, the leader lease, the
# elections and membership (elastic/) and the quorum-replicated KV
# (runtime/kvrep.py). The CNN trainer (sync and kofn) reads all of them;
# the asynchronous trainer across processes reads them too, those of
# ELASTIC_ONLY_FIELDS only under --elastic (``leader_lease_s`` also under
# --sync-topology hier, as the group lease's interval), as in the JAX
# package; the trainers in one process of --mode async and the LM read
# none.
CONTROL_FIELDS = ("fault_spec", "heartbeat_interval_s",
                  "heartbeat_timeout_s", "leader_lease_s", "elastic",
                  "elastic_leader", "kv_replicas", "kv_quorum",
                  "kv_resync_s")
ELASTIC_ONLY_FIELDS = ("leader_lease_s", "elastic_leader",
                       "heartbeat_interval_s", "heartbeat_timeout_s")
# Of the step options and the control plane, what the LM trainer reads
# (``runtime/lm_trainer.py``, as the JAX ``LMTrainer``): per-block remat and
# the fault plane, which fires the LM_FAULT_KINDS only.
LM_FIELDS = ("remat", "fault_spec")
LM_FAULT_KINDS = ("replica_crash", "ckpt_corrupt")
# Fault kinds that only ``serve.py`` fires; every trainer passes them by,
# as in the JAX package.
SERVING_FAULT_KINDS = ("replica_kill",)
# Fault kinds that only the asynchronous trainer across processes fires,
# and what they need: the synchronous trainers screen no contributions.
ASYNC_FAULT_KINDS = {"grad_poison": "the integrity screen of the async "
                                    "leader's pool"}
# Fault kinds that only the synchronous trainer fires, and what they need:
# the asynchronous trainers have no participation mask to poison.
SYNC_FAULT_KINDS = {"grad_nan": "a participation mask"}
# The ops plane (telemetry/): the CNN Trainer and the LMTrainer read these;
# of the asynchronous trainers, only the one across processes reads
# trace_file, as in the JAX package.
OPS_FIELDS = ("trace_file", "timeline_file", "metrics_port", "health_spec",
              "flight_file", "profile_dir", "profile_steps")
# Fields that only asynchronous training across processes reads
# (runtime/async_trainer.py).
WIRE_FIELDS = ("publish_every",)
# The gradient integrity screen (resilience/integrity.py): the leader of
# the asynchronous trainer across processes screens its pool with them, as
# in the JAX package; no other trainer reads them.
INTEGRITY_FIELDS = ("grad_integrity", "integrity_mad_threshold",
                    "integrity_strike_limit", "integrity_readmit_clean")
# The serving fields: ``serve.py`` reads them, no trainer does (the JAX
# trainers ignore them too).
SERVING_FIELDS = ("serve_slots", "serve_max_queue", "serve_reload_s",
                  "serve_port", "serve_host", "serve_deadline_s",
                  "serve_max_new", "slo_spec", "reqtrace_keep",
                  "reqtrace_sample", "serve_max_body_bytes", "serve_kv_dir",
                  "serve_fleet", "serve_replica_id", "serve_advertise")
# Fields whose validity depends on the launch (several processes or one).
LAUNCH_FIELDS = WIRE_FIELDS + ("trace_file",) + CONTROL_FIELDS

# The fields the port runs. Every other field must keep its default.
PORTED_FIELDS = frozenset(ASYNC_ONLY_FIELDS + SYNC_ONLY_FIELDS
                          + CONTROL_FIELDS + OPS_FIELDS + WIRE_FIELDS
                          + INTEGRITY_FIELDS + SERVING_FIELDS) | frozenset({
    "num_aggregate", "compress_grad", "codec_level", "donate", "shard_wire",
    "loader_workers",
    "kv_retry_attempts", "kv_retry_base_s", "kv_retry_budget",
    "network", "dataset", "batch_size", "test_batch_size", "data_dir",
    "num_classes", "optimizer", "lr", "lr_schedule", "lr_warmup_steps",
    "lr_decay_steps", "lr_decay_factor", "momentum", "weight_decay",
    "nesterov", "adam_beta1", "adam_beta2", "adam_eps", "amsgrad",
    "epochs", "max_steps", "eval_freq", "train_dir", "resume", "ckpt_keep",
    "seed", "mode", "compute_dtype", "device_normalize", "fused_optimizer",
    "conv_impl", "log_every", "metrics_file",
    "lm_vocab", "lm_d_model", "lm_layers", "lm_heads", "lm_seq_len",
    "lm_corpus_tokens", "lm_corpus_file", "lm_parallelism", "lm_attention",
})


def parse_profile_steps(spec: str) -> tuple:
    """``"lo-hi"`` or ``"n"`` -> (lo, hi), the inclusive window of steps
    that ``--profile-dir`` traces; raises ValueError unless
    0 < lo <= hi."""
    lo, _, hi = str(spec).partition("-")
    try:
        window = (int(lo), int(hi or lo))
    except ValueError:
        raise ValueError(f"profile_steps={spec!r} (want 'lo-hi' or 'n', "
                         "step numbers)") from None
    if not 0 < window[0] <= window[1]:
        raise ValueError(f"profile_steps={spec!r} (want 0 < lo <= hi)")
    return window


def checkpoint_config(config_json: str) -> TrainConfig:
    """The config a checkpoint was written under, for a reader that trains
    nothing (the evaluator): the launch that wrote it validated the
    fields of ``LAUNCH_FIELDS`` and no reader reads them, so they keep
    their defaults here, whatever this process's launch."""
    fields = json.loads(config_json)
    for name in LAUNCH_FIELDS:
        fields.pop(name, None)
    return TrainConfig(**fields)


def several_processes() -> bool:
    """True when the launch contract (``parallel/dist.py``) asks for more
    than one process."""
    return int(os.environ.get("PS_TPU_NUM_PROCESSES", "1") or "1") > 1


def refuse_multi_process(what: str) -> None:
    """Raise when the environment asks for more than one process, by
    torch's launcher contract (``WORLD_SIZE``) or the JAX package's
    (``PS_TPU_NUM_PROCESSES``, ``parallel/dist.py``), for a path that runs
    in one process only (``what``): each process would train a model of
    its own, unrelated to the others."""
    for name in ("WORLD_SIZE", "PS_TPU_NUM_PROCESSES"):
        n = int(os.environ.get(name, "1") or "1")
        if n > 1:
            raise ValueError(
                f"{name}={n}: {what} across several processes is not "
                "ported yet (ROADMAP.md); each would train its own model. "
                "Run one process (the CNN trainer runs one process a "
                "replica, or a slice with --mode async)")


def _parse_bool(s: str) -> bool:
    return s.lower() in ("1", "true", "yes")


def add_train_args(parser: Optional[argparse.ArgumentParser] = None
                   ) -> argparse.ArgumentParser:
    """The JAX trainer's CLI: one ``--flag`` per field. A bool flag also
    stands alone (``--fused-optimizer`` means ``--fused-optimizer true``)."""
    parser = parser or argparse.ArgumentParser(
        description="ps_pytorch_tpu_torch trainer")
    for f in dataclasses.fields(TrainConfig):
        name = "--" + f.name.replace("_", "-")
        if isinstance(f.default, bool):
            parser.add_argument(name, type=_parse_bool, nargs="?", const=True,
                                default=f.default, metavar="BOOL")
        else:
            parser.add_argument(name, type=type(f.default), default=f.default)
    return parser


def config_from_namespace(args: argparse.Namespace) -> TrainConfig:
    return TrainConfig(**{f.name: getattr(args, f.name)
                          for f in dataclasses.fields(TrainConfig)})


def config_from_args(argv: Optional[list] = None) -> TrainConfig:
    return config_from_namespace(add_train_args().parse_args(argv))
