"""The data-parallel step (``torch.distributed`` for more than one
replica), and the stale-gradient aggregator of the asynchronous path with
its bucket schedule and its two-tier tree (``async_dp``, ``buckets``,
``hierarchy``)."""

from ps_pytorch_tpu_torch.parallel.dp import (  # noqa: F401
    TrainStep, make_eval_step, make_train_step,
)
