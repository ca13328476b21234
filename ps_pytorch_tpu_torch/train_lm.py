"""LM training entry point of the port: ``python -m
ps_pytorch_tpu_torch.train_lm``.

Takes the root ``train_lm.py``'s flags (one per TrainConfig field) plus
``--device`` (default ``cuda``), and prints the same CONFIG, ``LM ...``,
STEP and FINAL lines. Sequence parallelism runs on one device, where
``--lm-attention flash`` goes through the hand-written CUDA kernels; a
launch of several processes raises (ROADMAP.md).
Example, the full-width LM of the JAX package's ``transformer_lm_2k_flash``
benchmark:

    python -m ps_pytorch_tpu_torch.train_lm --lm-attention flash \\
        --lm-d-model 512 --lm-layers 8 --lm-heads 8 --lm-vocab 32000 \\
        --lm-seq-len 2048 --batch-size 8 --lr 0.01 --momentum 0.9 \\
        --max-steps 5 --eval-freq 0 --resume false
"""

import sys

from ps_pytorch_tpu_torch.config import (
    add_train_args, config_from_namespace, refuse_multi_process,
)


def main(argv=None) -> int:
    from ps_pytorch_tpu_torch.runtime.lm_trainer import LMTrainer

    parser = add_train_args()
    parser.add_argument("--device", default="cuda",
                        help="torch device to train on (default cuda)")
    args = parser.parse_args(argv)
    refuse_multi_process("the LM")
    cfg = config_from_namespace(args)
    print(f"CONFIG {cfg.to_json()}")
    trainer = LMTrainer(cfg, device=args.device)
    print(f"LM mesh devices=1 parallelism={cfg.lm_parallelism} "
          f"attention={trainer.model.attention_impl} "
          f"seq_len={cfg.lm_seq_len} device={trainer.device}")
    trainer.train()
    result = trainer.evaluate(max_batches=8)
    print(f"FINAL lm_loss {result['loss']:.6f} "
          f"perplexity {result['perplexity']:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
