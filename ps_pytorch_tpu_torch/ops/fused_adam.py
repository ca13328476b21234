"""Fused Adam / AMSGrad update: one Triton kernel for the whole model.

Replaces the JAX package's ``ops/fused_adam.py:_make_kernel`` (the Pallas
kernel behind ``_fused_update_padded`` and ``FusedAdam.apply``) and computes
``optim/adam.py``'s exact step in one pass over flat f32 buffers:

    g  += wd * p
    m   = b1 * m + (1 - b1) * g
    v   = b2 * v + (1 - b2) * g * g
    vh  = max(vh, v)                             (AMSGrad)
    p  -= step_size * m / (sqrt(vh or v) + eps)

``step_size = lr_t * sqrt(1 - b2^t) / (1 - b1^t)`` is computed on the host
in float32 (``optim.adam.adam_step_size``) and reaches the kernel as a
runtime scalar, so a schedule and the bias correction never recompile;
b1, b2, eps, the weight decay and AMSGrad are compile-time constants.

Why Triton: the update is one elementwise pass with no reuse and no
tensor-core work, so all that matters is streaming the bytes at the card's
memory rate, which Triton's block model does. The kernel uses IEEE
``sqrt_rn`` and ``div_rn`` (Triton lowers ``sqrt`` and ``/`` to approximate
instructions) and no fused multiply-adds, so it does the plain version's
arithmetic rounding for rounding.

Bound on an H100: the pass reads p, m, v and g and writes p, m and v, 28 B
a parameter (36 B with AMSGrad, which reads and writes vh too); ResNet-18's
11.17M parameters move 313 MB a step, 93 us at 3.35 TB/s.

Memory: as ``FusedSGD``, ``FusedAdam.init`` makes every parameter a view of
one flat f32 buffer and keeps the moments as flat buffers; the kernel
updates all of them in place and reads the step's flat gradient buffer as
it is (the JAX version concatenates and splits every step,
``fused_adam.py:117-138``).
"""

from typing import Dict, Optional

import torch

from ps_pytorch_tpu_torch.ops._backend import use_kernel
from ps_pytorch_tpu_torch.ops.fused_sgd import (
    flat_grads, flatten_params, views_of,
)
from ps_pytorch_tpu_torch.optim.adam import Adam, AdamState, adam_update_

BLOCK = 1024

# The plain version, in place on flat f32 buffers: the plain optimizer's
# own update of one tensor.
fused_adam_reference = adam_update_


def fused_adam_update(p: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                      vh: Optional[torch.Tensor], g: torch.Tensor,
                      step_size: float, *, b1: float, b2: float, eps: float,
                      weight_decay: float) -> None:
    """One Adam step over flat f32 buffers, ``p``, ``m``, ``v`` and ``vh``
    (None without AMSGrad) in place. CUDA tensors run the kernel, CPU
    tensors the plain version. ``fused_adam_update.launches`` counts kernel
    launches."""
    bufs = {"p": p, "m": m, "v": v, "g": g}
    if vh is not None:
        bufs["vh"] = vh
    for name, t in bufs.items():
        if t.dim() != 1 or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D float32 "
                             f"tensor, got {t.dtype} {tuple(t.shape)}")
    if len({t.numel() for t in bufs.values()}) != 1:
        raise ValueError("sizes differ: " + ", ".join(
            f"{name} {t.numel()}" for name, t in bufs.items()))
    if not use_kernel(*bufs.values()):
        fused_adam_reference(p, m, v, vh, g, step_size, b1, b2, eps,
                             weight_decay)
        return
    if len({t.device for t in bufs.values()}) != 1:
        raise ValueError("the buffers must lie on one device")
    from ps_pytorch_tpu_torch.ops import _adam_triton
    with torch.cuda.device(p.device):
        _adam_triton.launch(p, m, v, vh, g, step_size, b1, b2, eps,
                            weight_decay, BLOCK)
    fused_adam_update.launches += 1


fused_adam_update.launches = 0


class FusedAdam(Adam):
    """The fused optimizer: ``optim.Adam``'s hyperparameters and
    ``init``/``apply`` contract. ``init`` makes the parameters views of one
    flat buffer (see the module note); ``apply`` updates them in place."""

    def init(self, params: Dict[str, torch.Tensor]) -> AdamState:
        flat_p = flatten_params(params, "FusedAdam")
        flat = (flat_p,) + tuple(torch.zeros_like(flat_p)
                                 for _ in range(3 if self.amsgrad else 2))
        moments = [views_of(b, params) for b in flat[1:]]
        return AdamState(step=0, exp_avg=moments[0], exp_avg_sq=moments[1],
                         max_exp_avg_sq=moments[2] if self.amsgrad else (),
                         flat=flat)

    def apply(self, params: Dict[str, torch.Tensor], state: AdamState,
              grads: Dict[str, torch.Tensor]) -> AdamState:
        """One step, in place on the parameters and the moments."""
        flat_p, flat_m, flat_v, *flat_vh = state.flat
        flat_g = flat_grads(params, flat_p, grads, "FusedAdam")
        fused_adam_update(flat_p, flat_m, flat_v,
                          flat_vh[0] if flat_vh else None, flat_g,
                          self.step_size(state), b1=self.b1, b2=self.b2,
                          eps=self.eps, weight_decay=self.weight_decay)
        return state._replace(step=state.step + 1)
