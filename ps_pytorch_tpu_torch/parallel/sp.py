"""The sequence-parallel LM train step and eval: the JAX package's
``parallel/sp.py`` (``_local_nexttoken_loss`` ``:59-81``,
``make_sp_train_step`` ``:84-128``, ``make_sp_eval_fn`` ``:131-151``).

The sequence is sharded over the ranks of one grid axis
(``parallel/mesh.py``): rank i holds tokens ``[i*S_local, (i+1)*S_local)``
of every row, its positions are offset by ``i * S_local``, and attention
crosses the shards as a ring (``attention_impl="ring"``). Without an axis,
or with an axis of one rank, the step is the one-device step it always
was.

Loss framing, as there: every position's target is the next token; the
boundary target of a shard's last position (the next shard's first token)
arrives by one permute of each shard's first token (rank i+1 to i), and
the global last position, whose target wraps to the first token, is
weighted out. The loss a rank differentiates is its LOCAL sum, with no
collective inside: differentiating through an all-reduce inside the loss
would count each cross-shard gradient once a rank (the JAX docstring's
double count). The ring's hops carry the cross-shard gradients; the step
then sums the gradients and the loss over the axis and divides by the
global token count ``B * (S - 1)``, and applies the optimizer
(``optim.SGD``, not fused, as ``lm_trainer.py:62-63``).
"""

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ps_pytorch_tpu_torch.parallel.collectives import (
    all_reduce_, all_reduce_flat_, shift_plain,
)


def _tokens(tokens, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(tokens)).to(device).long()


def _shards(axis) -> Tuple[int, int]:
    return (1, 0) if axis is None else (axis.size, axis.index)


def nexttoken_loss(model: torch.nn.Module, tokens: torch.Tensor,
                   axis=None) -> Tuple[torch.Tensor, float]:
    """(this rank's sum of next-token cross-entropy, its token count) over
    its [B, S_local] shard of the sequence."""
    b, s = tokens.shape
    n, idx = _shards(axis)
    positions = idx * s + torch.arange(s, device=tokens.device)
    logits = model(tokens, positions=positions)
    first_next = tokens[:, :1] if n == 1 else \
        shift_plain(tokens[:, :1], axis, -1)
    targets = torch.cat([tokens[:, 1:], first_next], dim=1)
    per_tok = F.cross_entropy(logits.reshape(b * s, -1), targets.reshape(-1),
                              reduction="none").reshape(b, s)
    w = torch.ones(s, device=tokens.device)
    last = idx == n - 1
    if last:
        w[-1] = 0.0               # the global last position has no target
    return (per_tok * w[None, :]).sum(), float((s - last) * b)


def global_count(tokens: torch.Tensor, axis=None) -> float:
    """The token count of the whole sequence, ``B * (n * S_local - 1)``."""
    b, s = tokens.shape
    return float((_shards(axis)[0] * s - 1) * b)


class LMTrainStep:
    """``step(tokens) -> {"loss": 0-d tensor}`` over this rank's
    [B, S_local] int batch (numpy or tensor); the optimizer state is
    ``step.opt_state``."""

    def __init__(self, model: torch.nn.Module, opt, axis=None):
        self.model, self.opt, self.axis = model, opt, axis
        self.device = next(model.parameters()).device
        self.params: Dict[str, torch.nn.Parameter] = dict(
            model.named_parameters())
        self.opt_state = opt.init(self.params)

    def __call__(self, tokens) -> Dict[str, torch.Tensor]:
        tokens = _tokens(tokens, self.device)
        self.model.train()
        for p in self.params.values():
            p.grad = None
        loss_sum, count = nexttoken_loss(self.model, tokens, self.axis)
        loss_sum.backward()
        with torch.no_grad():
            if _shards(self.axis)[0] > 1:
                count = global_count(tokens, self.axis)
                all_reduce_flat_([p.grad for p in self.params.values()],
                                 self.axis)
                loss_sum = all_reduce_(loss_sum.detach().clone(), self.axis)
            grads = {name: p.grad.div_(count)
                     for name, p in self.params.items()}
            self.opt_state = self.opt.apply(self.params, self.opt_state,
                                            grads)
        return {"loss": loss_sum.detach() / count}


def make_lm_eval_fn(model: torch.nn.Module, axis=None) -> Callable:
    """tokens (this rank's [B, S_local] shard) -> mean next-token loss over
    the whole sequence (0-d tensor), no gradients, through the same
    sharded forward as the train step: a full-attention model at the
    global length would hold the [S, S] scores the ring avoids."""
    device = next(model.parameters()).device

    @torch.no_grad()
    def eval_fn(tokens):
        model.eval()
        tokens = _tokens(tokens, device)
        loss_sum, count = nexttoken_loss(model, tokens, axis)
        if _shards(axis)[0] > 1:
            loss_sum = all_reduce_(loss_sum, axis)
            count = global_count(tokens, axis)
        return loss_sum / count

    return eval_fn


def sequence_shard(tokens: np.ndarray, axis: Optional[object]) -> np.ndarray:
    """This rank's slice of a [B, S] batch sharded over the sequence
    (the JAX ``P(None, "data")``)."""
    n, idx = _shards(axis)
    s = tokens.shape[1] // n
    return tokens[:, idx * s:(idx + 1) * s]
