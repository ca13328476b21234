"""Serve a ``train_lm`` checkpoint over HTTP with continuous batching:
``python -m ps_pytorch_tpu_torch.serve``, the port's root ``serve.py``.

The serving counterpart of ``generate``: instead of one ad-hoc decode,
stand up the full request lifecycle — bounded admission queue, slot-based
continuously-batched decode (``serving/``), and hot reload of newer VALID
checkpoints while requests stream (corrupt newest ones are walked past,
same contract as training resume). Checkpoints of either package serve.

    python -m ps_pytorch_tpu_torch.train_lm --train-dir ./lm ...
    python -m ps_pytorch_tpu_torch.serve --train-dir ./lm --serve-port 8300 \\
        --serve-slots 8 [--device cpu]
    curl -s localhost:8300/v1/generate -d '{"prompt": "def train(", "n_new": 64}'

Model geometry comes from the checkpoint's own config; the ``--serve-*``
flags (config.py) size the engine; ``--device`` (default ``cuda``) is
where it decodes, and a missing card is an error, never a CPU run.
Byte-level LM: "prompt" is UTF-8 text; send "tokens" (int list) for
non-byte vocabularies.

Fleet mode: pass ``--serve-kv-dir <dir> --serve-replica-id <i>`` and the
replica registers itself in the directory-backed coordination KV
(``serve/<fleet>/replica/<i>``) and beats a liveness lease from the serve
loop; point a ``serving.router.Router``'s FleetView at the same dir.
SIGTERM triggers graceful drain (stop admitting, finish in-flight,
deregister, exit 0) — the zero-downtime half of a rolling restart.
``--fault-spec "replica_kill:served=20,r=<i>"`` arms a SIGKILL after
that many requests. With ``--kv-replicas <spec,...>`` the registry rides
the quorum-replicated coordination plane (``runtime/kvrep.py``) instead of
a single directory.

The first line of standard output is one JSON object (the root
``serve.py``'s keys): the URL, the served step, the slots, the geometry.
"""

import argparse
import dataclasses
import json
import signal
import sys
import time


def main(argv=None) -> int:
    from ps_pytorch_tpu_torch.config import (
        TrainConfig, add_train_args, checkpoint_config,
    )

    p = add_train_args(argparse.ArgumentParser(
        description="ps_pytorch_tpu_torch serve"))
    p.add_argument("--device", default="cuda",
                   help="torch device to decode on (default cuda)")
    ns = p.parse_args(argv)
    try:
        args = TrainConfig(**{f.name: getattr(ns, f.name)
                              for f in dataclasses.fields(TrainConfig)})
    except ValueError as e:
        p.error(str(e))

    from ps_pytorch_tpu_torch.models.transformer import migrate_packed_qkv
    from ps_pytorch_tpu_torch.runtime import checkpoint as ckpt
    from ps_pytorch_tpu_torch.runtime.lm_eval import (
        build_lm_oracle, build_lm_template, lm_geometry,
    )
    from ps_pytorch_tpu_torch.runtime.trainer import (
        resolve_device, set_reference_numerics,
    )
    from ps_pytorch_tpu_torch.serving.engine import ServingEngine
    from ps_pytorch_tpu_torch.serving.reload import (
        CheckpointWatcher, restore_params,
    )
    from ps_pytorch_tpu_torch.serving.reqtrace import RequestTraceLog
    from ps_pytorch_tpu_torch.serving.server import ServingFrontend
    from ps_pytorch_tpu_torch.telemetry.health import HealthMonitor
    from ps_pytorch_tpu_torch.telemetry.registry import (
        Registry, declare_serving_metrics,
    )
    from ps_pytorch_tpu_torch.telemetry.slo import SLOTracker

    try:
        device = resolve_device(ns.device)
    except RuntimeError as e:
        p.error(str(e))
    set_reference_numerics()
    step = ckpt.latest_valid_step(args.train_dir)
    if step is None:
        p.error(f"no valid model_step_<k> checkpoints in {args.train_dir}")
    with open(f"{ckpt.checkpoint_path(args.train_dir, step)}/config.json") as f:
        config_json = f.read()
    network = json.loads(config_json).get("network")
    if network != "TransformerLM":
        # The engine's slot decode reuses the blocks' fixed-length k/v
        # cache, which the MoE blocks don't implement.
        p.error(f"serve.py decodes TransformerLM checkpoints; this one is "
                f"{network} (use generate.py for one-shot MoE decode)")
    try:
        cfg = checkpoint_config(config_json)
        # The checkpoints restore on the host, into a staging model and
        # its optimizer state (the training state's template); the served
        # model on the device takes a copy of the weights.
        staging, _ = build_lm_oracle(cfg, "cpu")
        template = (staging, build_lm_template(cfg, staging))
    except ValueError as e:
        p.error(str(e))
    got = ckpt.load_latest_valid(args.train_dir, lambda tree: restore_params(
        tree, template, migrate_packed_qkv))
    if got is None:
        p.error(f"no restorable checkpoint in {args.train_dir}")
    params, meta, _, step = got
    model, _ = build_lm_oracle(cfg, device)
    model.load_state_dict(params)

    geo = lm_geometry(cfg)
    registry = Registry()
    declare_serving_metrics(registry)
    # Request-scoped observability plane: lifecycle trace ring
    # (/debug/requests) and SLO burn-rate tracker (/slo), both optional.
    reqtrace = (RequestTraceLog(args.reqtrace_keep,
                                sample=args.reqtrace_sample)
                if args.reqtrace_keep > 0 else None)
    slo = (SLOTracker(args.slo_spec, registry=registry)
           if args.slo_spec else None)
    engine = ServingEngine(model, slots=args.serve_slots, model_step=step,
                           registry=registry, reqtrace=reqtrace, slo=slo)
    # Always build the watcher: the periodic poll is gated by
    # --serve-reload-s, but POST /admin/reload (a rolling reload) force-polls
    # regardless.
    watcher = CheckpointWatcher(args.train_dir, template,
                                migrate=migrate_packed_qkv, start_step=step)
    # Watchdog over the serve loop: the stall detector notices a wedged
    # drive thread (health.beat() runs once per loop iteration) and the
    # state shows up under /healthz's "health" key.
    health = HealthMonitor(args.health_spec or "stall:warn",
                           registry=registry)
    # Identity fields for /healthz: elastic training runs stamp which
    # leadership epoch committed each checkpoint (extra_meta); the serving
    # process itself is a single-process "leader" of its own plane.
    identity = {"leader": True, "role": "serving"}
    for k in ("leader_epoch", "leader_pid"):
        if k in meta:
            identity[k] = meta[k]
    # Fleet plane: registrar (KV record + liveness lease, beaten by the
    # serve loop) and the replica_kill fault injector.
    registrar = None
    if args.kv_replicas:
        # Quorum-replicated fleet registry: the replica record + liveness
        # lease survive loss of a minority of KV backends.
        from ps_pytorch_tpu_torch.runtime.kvrep import build_replicated_kv
        from ps_pytorch_tpu_torch.serving.router import FleetRegistrar
        fleet_kv = build_replicated_kv(
            args, process_index=args.serve_replica_id)
        registrar = FleetRegistrar(fleet_kv, args.serve_fleet,
                                   args.serve_replica_id)
        identity["replica_id"] = args.serve_replica_id
    elif args.serve_kv_dir:
        from ps_pytorch_tpu_torch.runtime.coordinator import FileKV
        from ps_pytorch_tpu_torch.serving.router import FleetRegistrar
        registrar = FleetRegistrar(FileKV(args.serve_kv_dir),
                                   args.serve_fleet, args.serve_replica_id)
        identity["replica_id"] = args.serve_replica_id
    injector = None
    if args.fault_spec:
        from ps_pytorch_tpu_torch.resilience.faults import FaultInjector
        injector = FaultInjector(args.fault_spec,
                                 process_index=args.serve_replica_id)
    frontend = ServingFrontend(
        engine, watcher=watcher, host=args.serve_host, port=args.serve_port,
        max_queue=args.serve_max_queue, reload_s=args.serve_reload_s,
        default_deadline_s=args.serve_deadline_s,
        default_n_new=args.serve_max_new, health=health, identity=identity,
        max_body_bytes=args.serve_max_body_bytes, registrar=registrar,
        injector=injector, advertise=args.serve_advertise)
    frontend.start()
    print(json.dumps({"serving": f"http://{args.serve_host}:{frontend.port}",
                      "metrics": f"http://{args.serve_host}:{frontend.port}"
                                 "/metrics",
                      "model_step": step, "slots": args.serve_slots,
                      "vocab": geo["vocab_size"],
                      "seq_len": geo["max_seq_len"],
                      "replica_id": (args.serve_replica_id
                                     if registrar else None),
                      "slo_spec": args.slo_spec or None,
                      "reqtrace_keep": args.reqtrace_keep}))
    sys.stdout.flush()

    # SIGTERM = graceful drain: stop admitting, finish in-flight slots,
    # deregister from the fleet, exit 0 — a rolling restart never turns
    # into client-visible errors.
    draining = {"flag": False}

    def _drain(signum, frame):
        draining["flag"] = True

    signal.signal(signal.SIGTERM, _drain)
    try:
        while not draining["flag"]:
            time.sleep(0.2)
    except KeyboardInterrupt:
        pass
    finally:
        frontend.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
