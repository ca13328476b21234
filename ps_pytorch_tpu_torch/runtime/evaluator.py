"""The standalone polling evaluator: the JAX package's
``runtime/evaluator.py``.

A separate process watches ``train_dir`` for ``model_step_<k>``, loads each
new checkpoint and prints loss, Prec@1 and Prec@5 on the test set as the
``EVAL`` line. The model and the test loader are built from the
checkpoint's own ``config.json``; the BatchNorm statistics are replica 0's.
An LM checkpoint gets the ``EVAL_LM`` line instead: the held-out
next-token loss, averaged over the validation tail's batches
(``TokenLoader(seed=0, shuffle=False)`` of ``lm_streams``), and its
perplexity. As in the JAX evaluator (``runtime/evaluator.py:80-104``), an
``sp`` checkpoint launched over N processes whose ``lm_seq_len`` divides
by N is scored through the ring forward over the N ranks
(``parallel/sp.py:make_lm_eval_fn`` over the world group, each rank its
shard of the sequence); every other LM checkpoint through the one-device
oracle (``runtime/lm_eval.py``, flash where the kernels take the head
dim) on every rank. Every rank prints the line. It reads checkpoints of
either package.
"""

import time
from typing import Callable, Optional

import torch

from ps_pytorch_tpu_torch.config import LM_NETWORKS, checkpoint_config
from ps_pytorch_tpu_torch.data import prepare_data
from ps_pytorch_tpu_torch.data.augment import input_norm_for
from ps_pytorch_tpu_torch.data.text import TokenLoader, lm_streams
from ps_pytorch_tpu_torch.models import build_model
from ps_pytorch_tpu_torch.models.convert import state_from_jax
from ps_pytorch_tpu_torch.models.transformer import TransformerLM
from ps_pytorch_tpu_torch.parallel import dist, make_eval_step
from ps_pytorch_tpu_torch.parallel.dp import accumulate_eval
from ps_pytorch_tpu_torch.parallel.mesh import Axis
from ps_pytorch_tpu_torch.parallel.sp import make_lm_eval_fn, sequence_shard
from ps_pytorch_tpu_torch.runtime import checkpoint as ckpt
from ps_pytorch_tpu_torch.runtime.lm_eval import (
    build_lm_oracle, build_lm_template, lm_geometry, perplexity, restore_lm,
    scoring_attention,
)
from ps_pytorch_tpu_torch.runtime.trainer import (
    resolve_device, set_reference_numerics,
)

EVAL_LINE = "EVAL step {step} loss {loss:.6f} prec1 {prec1:.4f} prec5 {prec5:.4f}"
EVAL_LM_LINE = "EVAL_LM step {step} loss {loss:.6f} perplexity {perplexity:.3f}"


class Evaluator:
    def __init__(self, train_dir: str, poll_s: float = 10.0,
                 printer: Callable = print, device: Optional[str] = None):
        set_reference_numerics()
        self.train_dir = train_dir
        self.poll_s = poll_s
        self.printer = printer
        self.device = resolve_device(device)
        self._built_for: Optional[str] = None
        self._lm = False

    def _build(self, config_json: str) -> None:
        cfg = checkpoint_config(config_json)
        self._lm = cfg.network in LM_NETWORKS
        if self._lm:
            self._build_lm(cfg)
            self._built_for = config_json
            return
        self.model = build_model(cfg.network, cfg.num_classes,
                                 cfg.compute_dtype, cfg.conv_impl
                                 ).to(self.device)
        _, self.test_loader = prepare_data(cfg)
        self.eval_fn = make_eval_step(self.model, input_norm_for(cfg))
        self._built_for = config_json

    def _build_lm(self, cfg) -> None:
        """The scoring model, its training-state template and the
        validation batches of an LM checkpoint's config: the ring model
        over every rank for an sp checkpoint whose sequence shards
        evenly, else the oracle."""
        n = dist.world()
        if cfg.lm_parallelism == "sp" and n > 1 and cfg.lm_seq_len % n == 0:
            axis = Axis("data", list(range(n)), dist.rank(), dist.group())
            with torch.device(self.device):
                self.model = TransformerLM(attention_impl="ring", axis=axis,
                                           **lm_geometry(cfg))
            eval_fn = make_lm_eval_fn(self.model, axis)

            def loss_fn(tokens) -> float:
                return float(eval_fn(sequence_shard(tokens, axis)))

            self._lm_loss = loss_fn
        else:
            self.model, self._lm_loss = build_lm_oracle(
                cfg, self.device, attention_impl=scoring_attention(cfg))
        self._lm_opt_state = build_lm_template(cfg, self.model)
        _, val = lm_streams(cfg)
        self._lm_val = TokenLoader(val, cfg.batch_size, cfg.lm_seq_len,
                                   seed=0, shuffle=False)

    def _evaluate_lm_step(self, step: int) -> dict:
        ckpt.load_checkpoint(self.train_dir, step, lambda tree: restore_lm(
            tree, self.model, self._lm_opt_state, step=step))
        losses = [self._lm_loss(t) for t in self._lm_val.epoch(0)]
        loss = sum(losses) / max(len(losses), 1)
        result = {"step": step, "loss": loss,
                  "perplexity": perplexity(loss)}
        self.printer(EVAL_LM_LINE.format(**result))
        return result

    def evaluate_step(self, step: int) -> dict:
        with open(f"{ckpt.checkpoint_path(self.train_dir, step)}/"
                  "config.json") as f:
            config_json = f.read()
        if config_json != self._built_for:
            self._build(config_json)
        if self._lm:
            return self._evaluate_lm_step(step)
        ckpt.load_checkpoint(self.train_dir, step,
                             lambda tree: state_from_jax(tree, self.model))
        result = accumulate_eval(self.eval_fn, self.test_loader.epoch(0))
        result = {"step": step, "loss": result["loss"],
                  "prec1": result["prec1"], "prec5": result["prec5"]}
        self.printer(EVAL_LINE.format(**result))
        return result

    def run(self, stop_after: Optional[int] = None,
            idle_timeout_s: Optional[float] = None) -> list:
        """Wake every ``poll_s`` and evaluate every committed step newer
        than the last one seen; return after ``stop_after`` was evaluated,
        or after ``idle_timeout_s`` with nothing new."""
        done, idle, results = -1, 0.0, []
        while True:
            steps = [s for s in ckpt.committed_steps(self.train_dir)
                     if s > done]
            if steps:
                for s in steps:
                    results.append(self.evaluate_step(s))
                done, idle = steps[-1], 0.0
                if stop_after is not None and done >= stop_after:
                    return results
            else:
                time.sleep(self.poll_s)
                idle += self.poll_s
                if idle_timeout_s is not None and idle >= idle_timeout_s:
                    return results
