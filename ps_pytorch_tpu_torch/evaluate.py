"""Polling evaluator entry point of the port: ``python -m
ps_pytorch_tpu_torch.evaluate``.

Takes the root ``evaluate.py``'s flags plus ``--device`` (default
``cuda``): it watches ``--train-dir`` and prints an ``EVAL`` line (loss,
Prec@1, Prec@5 on the test set) for each new ``model_step_<k>``, written by
either package; for an LM checkpoint the ``EVAL_LM`` line (held-out
next-token loss and perplexity).

    python -m ps_pytorch_tpu_torch.evaluate --train-dir ./train_dir \\
        [--poll-s 10] [--once STEP] [--stop-after STEP] [--idle-timeout-s S]

Started by the launcher (or under the JAX env contract), each process
joins the process group first, as the root ``evaluate.py`` does, and an
``sp`` checkpoint is scored through the ring over the ranks; every rank
prints the line:

    python -m ps_pytorch_tpu_torch.tools.launch launch --simulate 2 \\
        --wait --entry ps_pytorch_tpu_torch.evaluate -- \\
        --train-dir ./train_dir --once STEP
"""

import argparse
import sys


def main(argv=None) -> int:
    from ps_pytorch_tpu_torch.runtime import Evaluator

    p = argparse.ArgumentParser(description="ps_pytorch_tpu_torch evaluator")
    p.add_argument("--train-dir", default="./train_dir")
    p.add_argument("--poll-s", type=float, default=10.0)
    # None defaults keep step 0 and timeout 0 expressible.
    p.add_argument("--once", type=int, default=None,
                   help="evaluate exactly this step, then exit")
    p.add_argument("--stop-after", type=int, default=None,
                   help="exit once this step has been evaluated")
    p.add_argument("--idle-timeout-s", type=float, default=None,
                   help="exit after this long with no new checkpoint")
    p.add_argument("--device", default="cuda",
                   help="torch device to evaluate on (default cuda)")
    args = p.parse_args(argv)
    import torch

    from ps_pytorch_tpu_torch.parallel import dist
    try:
        dist.initialize_from_env(args.device)
        ev = Evaluator(args.train_dir, poll_s=args.poll_s,
                       device=str(dist.local_device(args.device)))
        if args.once is not None:
            ev.evaluate_step(args.once)
        else:
            ev.run(stop_after=args.stop_after,
                   idle_timeout_s=args.idle_timeout_s)
        if dist.is_multiprocess():
            # Process 0 serves the store: it leaves after the others.
            torch.distributed.barrier()
    finally:
        dist.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
