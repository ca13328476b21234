"""The training loop: the core loop of the JAX package's
``runtime/trainer.py`` (build ``:51-99``, ``train`` ``:517``, ``evaluate``
``:726``) on one process and one device.

next batch -> step (forward, backward, masked mean, update) -> STEP line.
The loop keeps the JAX trainer's 1-deep pipeline: step k is dispatched
before step k-1's metrics are read, and the reported step_time runs from
fetching the batch to that read. The optional planes of the JAX trainer
(checkpoints, coordinator, health, faults, telemetry exporters) are not
part of this slice (ROADMAP.md).
"""

import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ps_pytorch_tpu_torch.config import TrainConfig
from ps_pytorch_tpu_torch.data import prepare_data
from ps_pytorch_tpu_torch.data.augment import input_norm_for
from ps_pytorch_tpu_torch.models import build_model
from ps_pytorch_tpu_torch.optim import build_optimizer
from ps_pytorch_tpu_torch.parallel import make_eval_step, make_train_step
from ps_pytorch_tpu_torch.runtime.metrics import (
    MetricsLogger, derive_step_record,
)


def resolve_device(device: Optional[str] = None) -> torch.device:
    """``cuda`` unless the caller asks for another device; a CUDA device
    that is not there raises instead of running on the CPU."""
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to "
                           "run the plain versions on the CPU")
    return dev


def refuse_resume(cfg: TrainConfig) -> None:
    """Resuming is not ported: a train_dir that holds checkpoints raises
    unless ``--resume false``."""
    if cfg.resume and any(Path(cfg.train_dir).glob("model_step_*")):
        raise ValueError(f"{cfg.train_dir} holds checkpoints, and "
                         "resuming is not ported yet (ROADMAP.md); pass "
                         "--resume false or another --train-dir")


class Trainer:
    def __init__(self, cfg: TrainConfig, device: Optional[str] = None,
                 printer=print):
        self.cfg = cfg
        self.device = resolve_device(device)
        refuse_resume(cfg)
        self.model = build_model(cfg.network, cfg.num_classes,
                                 cfg.compute_dtype, cfg.conv_impl,
                                 seed=cfg.seed).to(self.device)
        self.opt = build_optimizer(cfg)
        self.train_loader, self.test_loader = prepare_data(cfg)
        input_norm = input_norm_for(cfg)
        self.step_fn = make_train_step(self.model, self.opt,
                                       input_norm=input_norm)
        self.eval_fn = make_eval_step(self.model, input_norm)
        self.metrics = MetricsLogger(cfg.metrics_file, cfg.log_every,
                                     printer=printer)
        self.step_times: list = []

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def train(self) -> None:
        """Run to max_steps or epochs * steps-per-epoch, whichever is
        smaller."""
        cfg = self.cfg
        steps_per_epoch = max(len(self.train_loader), 1)
        epoch_budget = (cfg.epochs * steps_per_epoch if cfg.epochs > 0
                        else cfg.max_steps)
        last_step = min(cfg.max_steps, epoch_budget)
        mask = np.ones(1, np.float32)
        step, m_prev = 0, None
        try:
            while step < last_step:
                step += 1
                t0 = time.monotonic()
                x, y = self.train_loader.next_batch()
                t_data = time.monotonic() - t0
                m = self.step_fn(x, y, mask)
                if m_prev is not None:
                    float(m_prev["loss"])       # the 1-deep pipeline's sync
                m_prev = m
                t_step = time.monotonic() - t0
                self.step_times.append(t_step)
                if step % cfg.log_every == 0 or step == last_step:
                    self.metrics.log_step(
                        step, (step - 1) // steps_per_epoch,
                        loss=float(m["loss"]), acc=float(m["accuracy"]),
                        participating=float(m["participating"]),
                        step_time=t_step, data_time=t_data,
                        **derive_step_record(step_time_s=t_step,
                                             data_time_s=t_data,
                                             examples=cfg.batch_size))
            self._sync()
        finally:
            self.metrics.close()

    def evaluate(self, max_batches: Optional[int] = None) -> dict:
        """Loss, top-1 and top-5 over the test loader (or its first
        ``max_batches`` batches)."""
        tot = {"sum_loss": 0.0, "top1": 0, "top5": 0, "count": 0}
        for i, (x, y) in enumerate(self.test_loader.epoch(0)):
            if max_batches is not None and i >= max_batches:
                break
            m = self.eval_fn(x, y)
            tot["sum_loss"] += float(m["sum_loss"])
            for k in ("top1", "top5", "count"):
                tot[k] += int(m[k])
        self.model.train()
        n = max(tot["count"], 1)
        return {"loss": tot["sum_loss"] / n, "prec1": tot["top1"] / n,
                "prec5": tot["top5"] / n, "count": tot["count"]}
