"""The LM train step and eval on one device: the JAX package's
``parallel/sp.py`` (``_local_nexttoken_loss`` ``:59-81``,
``make_sp_train_step`` ``:84-128``, ``make_sp_eval_fn`` ``:131-151``) with
the sequence on one shard.

Loss framing, as there with one shard: every position's target is the next
token, the last position's target wraps to the first token and is weighted
out, so the mean is over ``B * (S - 1)`` tokens. The step differentiates the
loss SUM and divides the gradients by the token count, as the JAX step
divides its psum of gradients, then applies the optimizer (``optim.SGD``,
not fused, as ``lm_trainer.py:62-63``). Sharding the sequence over devices
(ring attention) waits for ``torch.distributed`` (ROADMAP.md).
"""

from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _tokens(tokens, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(tokens)).to(device).long()


def nexttoken_loss(model: torch.nn.Module, tokens: torch.Tensor
                   ) -> Tuple[torch.Tensor, float]:
    """(sum of next-token cross-entropy, token count) over [B, S] tokens."""
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device)
    logits = model(tokens, positions=positions)
    targets = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    per_tok = F.cross_entropy(logits.reshape(b * s, -1), targets.reshape(-1),
                              reduction="none").reshape(b, s)
    w = torch.ones(s, device=tokens.device)
    w[-1] = 0.0                   # the last position has no target
    return (per_tok * w[None, :]).sum(), float((s - 1) * b)


class LMTrainStep:
    """``step(tokens) -> {"loss": 0-d tensor}`` over a [B, S] int batch
    (numpy or tensor); the optimizer state is ``step.opt_state``."""

    def __init__(self, model: torch.nn.Module, opt):
        self.model, self.opt = model, opt
        self.device = next(model.parameters()).device
        self.params: Dict[str, torch.nn.Parameter] = dict(
            model.named_parameters())
        self.opt_state = opt.init(self.params)

    def __call__(self, tokens) -> Dict[str, torch.Tensor]:
        tokens = _tokens(tokens, self.device)
        self.model.train()
        for p in self.params.values():
            p.grad = None
        loss_sum, count = nexttoken_loss(self.model, tokens)
        loss_sum.backward()
        with torch.no_grad():
            grads = {name: p.grad.div_(count)
                     for name, p in self.params.items()}
            self.opt_state = self.opt.apply(self.params, self.opt_state,
                                            grads)
        return {"loss": loss_sum.detach() / count}


def make_lm_eval_fn(model: torch.nn.Module) -> Callable:
    """tokens [B, S] -> mean next-token loss (0-d tensor), no gradients,
    the train step's framing."""
    device = next(model.parameters()).device

    @torch.no_grad()
    def eval_fn(tokens):
        model.eval()
        loss_sum, count = nexttoken_loss(model, _tokens(tokens, device))
        return loss_sum / count

    return eval_fn
