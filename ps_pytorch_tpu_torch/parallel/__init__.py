"""The data-parallel step (``torch.distributed`` for more than one
replica), the stale-gradient aggregator of the asynchronous path with
its bucket schedule and its two-tier tree (``async_dp``, ``buckets``,
``hierarchy``), and the LM across ranks (``mesh``, ``collectives``,
``ring``, ``sp``, ``tp``, ``pp``)."""

from ps_pytorch_tpu_torch.parallel.dp import (  # noqa: F401
    TrainStep, make_eval_step, make_train_step,
)
