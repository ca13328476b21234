"""LM training entry point of the port: ``python -m
ps_pytorch_tpu_torch.train_lm``.

Takes the root ``train_lm.py``'s flags (one per TrainConfig field) plus
``--device`` (default ``cuda``), and prints the same CONFIG, ``LM ...``,
STEP and FINAL lines. Started by the port's launcher (``tools/launch.py``)
or by hand with the JAX package's env contract (``parallel/dist.py``),
each process is one rank of the LM's grid: it joins the process group
before any model is built and prints ``DIST process <rank>/<world>``; an
incomplete contract raises, as ``train.py``'s does. ``--lm-parallelism
sp`` shards the sequence over the ranks (ring attention, ``--lm-attention
auto``), ``tp`` and ``pp`` shard the model over ``--lm-model-axis`` ranks
and the batch over the rest (``runtime/lm_trainer.py``). Ranks that share
a card run over gloo (``parallel/dist.py:choose_backend``).

The full-width LM of the JAX package's ``transformer_lm_2k_flash``
benchmark on one card, through the hand-written flash kernels:

    python -m ps_pytorch_tpu_torch.train_lm --lm-attention flash \\
        --lm-d-model 512 --lm-layers 8 --lm-heads 8 --lm-vocab 32000 \\
        --lm-seq-len 2048 --batch-size 8 --lr 0.01 --momentum 0.9 \\
        --max-steps 5 --eval-freq 0 --resume false

the same model as a two-stage pipeline on two ranks, its stages on the
flash kernels:

    python -m ps_pytorch_tpu_torch.tools.launch launch --simulate 2 \\
        --entry ps_pytorch_tpu_torch.train_lm --wait -- \\
        --lm-parallelism pp --lm-model-axis 2 --lm-microbatches 4 \\
        --lm-attention flash --lm-d-model 512 --lm-layers 8 --lm-heads 8 \\
        --lm-vocab 32000 --lm-seq-len 2048 --batch-size 8 --lr 0.01 \\
        --momentum 0.9 --max-steps 3 --eval-freq 3 --train-dir /tmp/td
"""

import sys

from ps_pytorch_tpu_torch.config import add_train_args, config_from_namespace


def run(argv=None):
    """``main`` without the exit code: returns the trainer and its final
    evaluation, after the FINAL line, for scripts that read them."""
    from ps_pytorch_tpu_torch.parallel import dist
    from ps_pytorch_tpu_torch.runtime.lm_trainer import LMTrainer

    parser = add_train_args()
    parser.add_argument("--device", default="cuda",
                        help="torch device to train on (default cuda)")
    args = parser.parse_args(argv)
    cfg = config_from_namespace(args)
    try:
        if dist.initialize_from_env(args.device) is not None:
            print(f"DIST process {dist.rank()}/{dist.world()}")
        print(f"CONFIG {cfg.to_json()}")
        trainer = LMTrainer(cfg, device=str(dist.local_device(args.device)))
        print(f"LM mesh devices={trainer.world} "
              f"parallelism={cfg.lm_parallelism} "
              f"attention={trainer.model.attention_impl} "
              f"seq_len={cfg.lm_seq_len} backend={dist.backend()} "
              f"device={trainer.device}")
        trainer.train()
        result = trainer.evaluate(max_batches=8)
        print(f"FINAL lm_loss {result['loss']:.6f} "
              f"perplexity {result['perplexity']:.3f}")
        return trainer, result
    finally:
        dist.shutdown()


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
