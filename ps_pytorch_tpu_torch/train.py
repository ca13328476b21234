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
``SLICES`` in place of ``MESH``; launched as several processes it trains
one slice a process (``runtime/async_trainer.py``: gradients cross between
processes as armoured bytes over the group's TCPStore, process 0 is the PS
leader) and prints ``ASYNC process-slices <n> x 1 devices``. The LM
refuses a launch of several processes (ROADMAP.md). Example, ResNet-18 on
CIFAR-10 geometry through the hand-written conv3x3 and fused-Adam
kernels:

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
            trainer = MultiSliceTrainer(cfg, n_slices=cfg.async_slices,
                                        fetch_every=cfg.fetch_every,
                                        device=args.device)
            print(f"SLICES {cfg.async_slices} x 1 devices")
        else:
            trainer = Trainer(cfg, device=str(dist.local_device(args.device)))
            print(f"MESH data={trainer.world} model=1 devices="
                  f"{trainer.world} backend={dist.backend()} "
                  f"device={trainer.device}")
        trainer.train()
        result = trainer.evaluate()
        print(f"FINAL loss {result['loss']:.6f} prec1 {result['prec1']:.4f} "
              f"prec5 {result['prec5']:.4f}")
        if isinstance(trainer, AsyncTrainer):
            trainer.leave()     # process 0 keeps the store up till the last
        return trainer, result
    finally:
        dist.shutdown()


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
