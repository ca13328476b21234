"""Training entry point of the port: ``python -m ps_pytorch_tpu_torch.train``.

Takes the root ``train.py``'s flags (one per TrainConfig field; a bool flag
may stand alone) plus ``--device`` (default ``cuda``). Prints the same
CONFIG, STEP and FINAL lines as the JAX trainer, writes ``model_step_<k>``
into ``--train-dir`` every ``--eval-freq`` steps, and resumes from the
newest valid one unless ``--resume false``.

``--mode sync`` and ``--mode kofn`` run one process a replica. Started by
the port's launcher (``tools/launch.py``), or by hand with the JAX
package's env contract (``PS_TPU_COORDINATOR``, ``PS_TPU_NUM_PROCESSES``,
``PS_TPU_PROCESS_ID``; ``parallel/dist.py``), each process joins the
process group before any model is built and prints ``MESH data=<world>
... backend=<nccl|gloo>``; without the contract it trains alone
(``backend=none``). ``--mode async`` trains ``--async-slices`` slices
asynchronously in one process (``runtime/multislice.py``) and prints
``SLICES <n> x <devices a slice>`` in place of ``MESH``: with several
visible cards the slices split them all, as the JAX entry splits every
local device (their count must divide by the slices), with one every
slice shares it; launched as several processes it trains
one slice a process (``runtime/async_trainer.py``: gradients cross between
processes as armoured bytes over the group's TCPStore, process 0 is the PS
leader) and prints ``ASYNC process-slices <n> x 1 devices``. The LM
trains across processes through ``python -m
ps_pytorch_tpu_torch.train_lm``. With
``--auto-resume N`` a synchronous run that crashes (an injected
``replica_crash`` of ``--fault-spec``, or any exception) is rebuilt from
its newest valid checkpoint, up to N times, printing ``CRASH ...``.
Example, ResNet-18 on CIFAR-10 geometry through the hand-written conv3x3
and fused-Adam kernels:

    python -m ps_pytorch_tpu_torch.train --network ResNet18 \
        --dataset synthetic_cifar10 --batch-size 256 \
        --compute-dtype bfloat16 --conv-impl pallas --optimizer adam \
        --fused-optimizer --lr 1e-3 --weight-decay 5e-4 --max-steps 6 \
        --eval-freq 3 --train-dir /tmp/td

the same network on two ranks, K-of-N with one backup worker:

    python -m ps_pytorch_tpu_torch.tools.launch launch --simulate 2 \
        --wait -- --mode kofn --num-aggregate 1 --network ResNet18 \
        --dataset synthetic_cifar10 --batch-size 256 \
        --compute-dtype bfloat16 --conv-impl pallas --fused-optimizer \
        --max-steps 8 --eval-freq 4 --train-dir /tmp/td

and trained by two asynchronous slices whose gradients cross between them
as int8 through the hand-written quantize kernel:

    python -m ps_pytorch_tpu_torch.train --mode async --async-slices 2 \
        --network ResNet18 --dataset synthetic_cifar10 --batch-size 256 \
        --compute-dtype bfloat16 --conv-impl pallas --fused-optimizer \
        --compress-grad --grad-codec int8 --max-steps 6 --eval-freq 0

or by two processes, the int8 gradients crossing between them on the wire:

    python -m ps_pytorch_tpu_torch.tools.launch launch --simulate 2 \
        --wait -- --mode async --staleness-limit 8 --network ResNet18 \
        --dataset synthetic_cifar10 --batch-size 256 \
        --compute-dtype bfloat16 --conv-impl pallas --fused-optimizer \
        --compress-grad --grad-codec int8 --max-steps 6 --eval-freq 3 \
        --train-dir /tmp/td
"""

import sys

from ps_pytorch_tpu_torch.config import add_train_args, config_from_namespace


def run(argv=None):
    """``main`` without the exit code: returns the trainer and its final
    evaluation, after the FINAL line, for scripts that read them."""
    from ps_pytorch_tpu_torch.parallel import dist
    from ps_pytorch_tpu_torch.runtime import (
        AsyncTrainer, MultiSliceTrainer, Trainer,
    )

    parser = add_train_args()
    parser.add_argument("--device", default="cuda",
                        help="torch device to train on (default cuda)")
    args = parser.parse_args(argv)
    cfg = config_from_namespace(args)
    try:
        dist.initialize_from_env(args.device)
        print(f"CONFIG {cfg.to_json()}")
        if cfg.mode == "async" and dist.is_multiprocess():
            trainer = AsyncTrainer(cfg, device=args.device)
            print(f"ASYNC process-slices {trainer.n} x 1 devices")
        elif cfg.mode == "async":
            trainer = MultiSliceTrainer(
                cfg, n_slices=cfg.async_slices, fetch_every=cfg.fetch_every,
                devices=_slice_devices(args.device, cfg.async_slices),
                device=args.device)
            print(f"SLICES {cfg.async_slices} x {trainer.per} devices")
        elif cfg.auto_resume > 0:
            trainer = _train_with_auto_resume(
                cfg, str(dist.local_device(args.device)))
        else:
            trainer = Trainer(cfg, device=str(dist.local_device(args.device)))
            _print_mesh(trainer)
        if not cfg.auto_resume:     # else the restart loop trained it
            trainer.train()
        result = trainer.evaluate()
        print(f"FINAL loss {result['loss']:.6f} prec1 {result['prec1']:.4f} "
              f"prec5 {result['prec5']:.4f}")
        if isinstance(trainer, AsyncTrainer):
            trainer.leave()     # process 0 keeps the store up till the last
        return trainer, result
    finally:
        dist.shutdown()


def _slice_devices(device: str, n_slices: int):
    """The devices of the one-process async trainer, as the JAX entry
    hands it every local device: every visible card when ``device`` is
    ``cuda`` without an index and there are several (their count must
    divide into ``n_slices`` slices), else None (every slice on
    ``device``; with one card every slice shares it)."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None \
            or not torch.cuda.is_available():
        return None
    n = torch.cuda.device_count()
    if n == 1:
        return None
    if n % n_slices:
        raise ValueError(f"{n} devices not divisible by {n_slices} slices")
    return [f"cuda:{i}" for i in range(n)]


def _print_mesh(trainer) -> None:
    from ps_pytorch_tpu_torch.parallel import dist
    print(f"MESH data={trainer.world} model=1 devices={trainer.world} "
          f"backend={dist.backend()} device={trainer.device}")


def _train_with_auto_resume(cfg, device: str):
    """Crash containment (the root ``train.py:52-80``): a step loop that
    raises is rebuilt, up to ``--auto-resume`` times, and the rebuilt
    Trainer restores the newest checkpoint that verifies and replays its
    data stream to it. One FaultInjector lives across the rebuilds, so a
    once-only fault does not fire again. Returns the last Trainer,
    trained."""
    import dataclasses

    from ps_pytorch_tpu_torch import resilience
    from ps_pytorch_tpu_torch.parallel import dist
    from ps_pytorch_tpu_torch.runtime import Trainer

    injector = (resilience.FaultInjector(cfg.fault_spec,
                                         process_index=dist.rank())
                if cfg.fault_spec else None)
    # The first build honours --resume; a rebuild always resumes.
    rebuild_cfg = dataclasses.replace(cfg, resume=True)
    last = []

    def make_trainer():
        trainer = Trainer(rebuild_cfg if last else cfg, device=device,
                          injector=injector)
        if not last:
            _print_mesh(trainer)
        last[:] = [trainer]     # a crashed trainer's tensors go with it
        return trainer

    resilience.run_with_auto_resume(make_trainer,
                                    max_restarts=cfg.auto_resume,
                                    exceptions=(Exception,))
    return last[0]


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
