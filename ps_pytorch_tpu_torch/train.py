"""Training entry point of the port: ``python -m ps_pytorch_tpu_torch.train``.

Takes the root ``train.py``'s flags (one per TrainConfig field; a bool flag
may stand alone) plus ``--device`` (default ``cuda``). Prints the same
CONFIG, STEP and FINAL lines as the JAX trainer, writes ``model_step_<k>``
into ``--train-dir`` every ``--eval-freq`` steps, and resumes from the
newest valid one unless ``--resume false``. ``--mode async`` trains
``--async-slices`` slices asynchronously in this one process
(``runtime/multislice.py``) and prints ``SLICES`` in place of ``MESH``. A
launch of several processes (``WORLD_SIZE`` or ``PS_TPU_NUM_PROCESSES``
above 1) is not ported yet and raises (ROADMAP.md).
Example, ResNet-18 on CIFAR-10
geometry through the hand-written conv3x3 and fused-Adam kernels:

    python -m ps_pytorch_tpu_torch.train --network ResNet18 \
        --dataset synthetic_cifar10 --batch-size 256 \
        --compute-dtype bfloat16 --conv-impl pallas --optimizer adam \
        --fused-optimizer --lr 1e-3 --weight-decay 5e-4 --max-steps 6 \
        --eval-freq 3 --train-dir /tmp/td

and the same network trained by two asynchronous slices whose gradients
cross between them as int8 through the hand-written quantize kernel:

    python -m ps_pytorch_tpu_torch.train --mode async --async-slices 2 \
        --network ResNet18 --dataset synthetic_cifar10 --batch-size 256 \
        --compute-dtype bfloat16 --conv-impl pallas --fused-optimizer \
        --compress-grad --grad-codec int8 --max-steps 6 --eval-freq 0
"""

import sys

from ps_pytorch_tpu_torch.config import (
    add_train_args, config_from_namespace, refuse_multi_process,
)


def main(argv=None) -> int:
    from ps_pytorch_tpu_torch.runtime import MultiSliceTrainer, Trainer

    parser = add_train_args()
    parser.add_argument("--device", default="cuda",
                        help="torch device to train on (default cuda)")
    args = parser.parse_args(argv)
    refuse_multi_process()
    cfg = config_from_namespace(args)
    print(f"CONFIG {cfg.to_json()}")
    if cfg.mode == "async":
        trainer = MultiSliceTrainer(cfg, n_slices=cfg.async_slices,
                                    fetch_every=cfg.fetch_every,
                                    device=args.device)
        print(f"SLICES {cfg.async_slices} x 1 devices")
    else:
        trainer = Trainer(cfg, device=args.device)
        print(f"MESH data=1 model=1 devices=1 device={trainer.device}")
    trainer.train()
    result = trainer.evaluate()
    print(f"FINAL loss {result['loss']:.6f} prec1 {result['prec1']:.4f} "
          f"prec5 {result['prec5']:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
