"""Polling evaluator entry point of the port: ``python -m
ps_pytorch_tpu_torch.evaluate``.

Takes the root ``evaluate.py``'s flags plus ``--device`` (default
``cuda``): it watches ``--train-dir`` and prints an ``EVAL`` line (loss,
Prec@1, Prec@5 on the test set) for each new ``model_step_<k>``, written by
either package; for an LM checkpoint the ``EVAL_LM`` line (held-out
next-token loss and perplexity).

    python -m ps_pytorch_tpu_torch.evaluate --train-dir ./train_dir \\
        [--poll-s 10] [--once STEP] [--stop-after STEP] [--idle-timeout-s S]
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
    ev = Evaluator(args.train_dir, poll_s=args.poll_s, device=args.device)
    if args.once is not None:
        ev.evaluate_step(args.once)
        return 0
    ev.run(stop_after=args.stop_after, idle_timeout_s=args.idle_timeout_s)
    return 0


if __name__ == "__main__":
    sys.exit(main())
