"""Adam / AMSGrad: the JAX package's ``optim/adam.py`` update, exactly:

    t <- t + 1
    g  = g + wd * p
    m  = b1 * m + (1 - b1) * g
    v  = b2 * v + (1 - b2) * g * g
    vhat = max(vhat, v) if amsgrad else v
    step_size = lr_t * sqrt(1 - b2^t) / (1 - b1^t)
    p <- p - step_size * m / (sqrt(vhat) + eps)      # eps outside the sqrt

Functional like ``optim/sgd.py``: ``init(params) -> AdamState`` and
``apply(params, state, grads) -> AdamState``, updating the parameters and
the moments in place. ``lr`` is a float or a ``step -> lr`` schedule read
at ``state.step``.
"""

from typing import Any, Callable, Dict, NamedTuple, Optional, Union

import numpy as np
import torch


class AdamState(NamedTuple):
    step: int                  # updates applied so far
    exp_avg: Any               # name -> first moment
    exp_avg_sq: Any            # name -> second moment
    max_exp_avg_sq: Any        # name -> running max of v, or () (no AMSGrad)
    flat: tuple = ()           # FusedAdam: (flat p, flat m, flat v[, flat vh])


def adam_step_size(lr_t: float, b1: float, b2: float, t: int) -> float:
    """``lr_t * sqrt(1 - b2^t) / (1 - b1^t)`` in float32, as the JAX
    package computes it (t cast to float32, the Python floats taking the
    array's type)."""
    f32 = np.float32
    tf = f32(t)
    return float(f32(lr_t) * np.sqrt(f32(1.0) - f32(b2) ** tf)
                 / (f32(1.0) - f32(b1) ** tf))


@torch.no_grad()
def adam_update_(p: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                 vh: Optional[torch.Tensor], g: torch.Tensor,
                 step_size: float, b1: float, b2: float, eps: float,
                 weight_decay: float) -> None:
    """One Adam step on one tensor, in place on ``p``, ``m``, ``v`` and
    ``vh`` (None without AMSGrad), in the JAX package's order of
    operations."""
    if weight_decay != 0.0:
        g = g + weight_decay * p
    m.mul_(b1).add_((1.0 - b1) * g)
    v.mul_(b2).add_((1.0 - b2) * g * g)
    if vh is not None:
        torch.maximum(vh, v, out=vh)
    p.sub_(step_size * m / (torch.sqrt(v if vh is None else vh) + eps))


class Adam:
    def __init__(self, lr: Union[float, Callable], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, amsgrad: bool = False):
        self.lr = lr
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.amsgrad = amsgrad

    def init(self, params: Dict[str, torch.Tensor]) -> AdamState:
        def zeros():
            return {name: torch.zeros_like(p) for name, p in params.items()}
        return AdamState(step=0, exp_avg=zeros(), exp_avg_sq=zeros(),
                         max_exp_avg_sq=zeros() if self.amsgrad else ())

    def step_size(self, state: AdamState) -> float:
        lr_t = self.lr(state.step) if callable(self.lr) else self.lr
        return adam_step_size(lr_t, self.b1, self.b2, state.step + 1)

    def apply(self, params: Dict[str, torch.Tensor], state: AdamState,
              grads: Dict[str, torch.Tensor]) -> AdamState:
        ss = self.step_size(state)
        for name, p in params.items():
            adam_update_(p, state.exp_avg[name], state.exp_avg_sq[name],
                         state.max_exp_avg_sq[name] if self.amsgrad else None,
                         grads[name], ss, self.b1, self.b2, self.eps,
                         self.weight_decay)
        return state._replace(step=state.step + 1)
