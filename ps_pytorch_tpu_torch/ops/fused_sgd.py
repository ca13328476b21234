"""Fused momentum-SGD update: one Triton kernel for the whole model.

Replaces the JAX package's ``ops/fused_sgd.py:_make_kernel`` (the Pallas
kernel behind ``_fused_update_padded`` and ``FusedSGD.apply``) and computes
the reference's exact SGD step (``optim/sgd.py``) in one pass:

    d_p = g + wd * p
    buf = d_p on the first step, else mu * buf + (1 - damp) * d_p
    d   = d_p + mu * buf (Nesterov) or buf
    p  -= lr * d

Why Triton: the update is a pure elementwise pass with no reuse and no
tensor-core work, and Triton's block model reaches the card's memory rate
for such a pass. ``lr`` and the first-step flag are runtime scalars, so a
schedule does not recompile; momentum, dampening, weight decay and Nesterov
are compile-time constants.

Bound on an H100: the pass reads p, buf and g and writes p and buf, 20 B a
parameter; ResNet-18's 11.2M parameters move about 224 MB a step, 67 us at
3.35 TB/s. On the first step the old buffer is not read (16 B a parameter).

Memory: ``FusedSGD.init`` moves the parameters into one flat f32 buffer and
makes every parameter a view of it, and keeps the momentum in a second flat
buffer. The kernel updates both in place, so there is no concatenation and
no split per step (the JAX version concatenates, ``fused_sgd.py:125-133``).
Gradients that are views of one flat buffer in the same order (the data
parallel step's reduced gradient buffer) are read as they are; any other
gradients are concatenated first.
"""

from typing import Dict, Optional, Sequence

import torch

from ps_pytorch_tpu_torch.ops._backend import use_kernel
from ps_pytorch_tpu_torch.optim.sgd import SGD, SGDState

BLOCK = 1024


def fused_sgd_reference(p: torch.Tensor, b: torch.Tensor, g: torch.Tensor,
                        lr: float, first: bool, momentum: float,
                        dampening: float, weight_decay: float,
                        nesterov: bool) -> None:
    """The plain version, in place on flat f32 ``p`` and ``b``."""
    d_p = g + weight_decay * p if weight_decay != 0.0 else g
    if first:
        b.copy_(d_p)
    else:
        b.copy_(momentum * b + (1.0 - dampening) * d_p)
    d = d_p + momentum * b if nesterov else b
    p.sub_(lr * d)


def fused_sgd_update(p: torch.Tensor, b: torch.Tensor, g: torch.Tensor,
                     lr: float, first: bool, *, momentum: float,
                     dampening: float, weight_decay: float,
                     nesterov: bool) -> None:
    """One SGD step over flat f32 buffers, ``p`` and ``b`` in place. CUDA
    tensors run the kernel, CPU tensors the plain version.
    ``fused_sgd_update.launches`` counts kernel launches."""
    for name, t in (("p", p), ("b", b), ("g", g)):
        if t.dim() != 1 or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D float32 "
                             f"tensor, got {t.dtype} {tuple(t.shape)}")
    if not p.numel() == b.numel() == g.numel():
        raise ValueError(f"sizes differ: p {p.numel()} b {b.numel()} "
                         f"g {g.numel()}")
    if not use_kernel(p, b, g):
        fused_sgd_reference(p, b, g, lr, first, momentum, dampening,
                            weight_decay, nesterov)
        return
    if not p.device == b.device == g.device:
        raise ValueError("p, b and g must lie on one device")
    from ps_pytorch_tpu_torch.ops import _sgd_triton
    with torch.cuda.device(p.device):
        _sgd_triton.launch(p, b, g, lr, first, momentum, dampening,
                           weight_decay, nesterov, BLOCK)
    fused_sgd_update.launches += 1


fused_sgd_update.launches = 0


def flat_base(tensors: Sequence[torch.Tensor]) -> Optional[torch.Tensor]:
    """The 1-D buffer that ``tensors`` tile exactly, in order, as views;
    None if they do not."""
    base = tensors[0]._base if tensors else None
    if base is None or base.dim() != 1 or not base.is_contiguous():
        return None
    ptr, size = base.data_ptr(), base.element_size()
    for t in tensors:
        if t._base is not base or t.data_ptr() != ptr \
                or not t.is_contiguous():
            return None
        ptr += t.numel() * size
    return base if ptr == base.data_ptr() + base.numel() * size else None


def flatten_params(params: Dict[str, torch.Tensor], optimizer: str
                   ) -> torch.Tensor:
    """Lay ``params`` out in one flat f32 buffer, in order, and rebind each
    to its view (``p.data = view``). Returns the buffer. A single
    contiguous 1-D tensor (the sharded update's slice) is its own flat
    buffer and stays where it is."""
    if not params:
        raise ValueError("no parameters")
    ref = next(iter(params.values()))
    for name, p in params.items():
        if p.dtype != torch.float32 or p.device != ref.device:
            raise ValueError(f"{name}: {optimizer} takes float32 "
                             "parameters on one device")
    if len(params) == 1 and ref.dim() == 1 and ref.is_contiguous():
        return ref
    total = sum(p.numel() for p in params.values())
    flat_p = torch.empty(total, dtype=torch.float32, device=ref.device)
    with torch.no_grad():
        for name, view in views_of(flat_p, params).items():
            view.copy_(params[name])
            params[name].data = view
    return flat_p


def views_of(flat: torch.Tensor, params: Dict[str, torch.Tensor]) -> dict:
    """name -> the view of ``flat`` at that parameter's place."""
    out, off = {}, 0
    for name, p in params.items():
        out[name] = flat[off:off + p.numel()].view_as(p)
        off += p.numel()
    return out


def flat_grads(params: Dict[str, torch.Tensor], flat_p: torch.Tensor,
               grads: Dict[str, torch.Tensor], optimizer: str
               ) -> torch.Tensor:
    """Check that ``params`` still lie where ``flatten_params`` put them,
    and return the flat gradient: the buffer that ``grads`` are views of
    (the data-parallel step's reduced gradient) as it is, else their
    concatenation."""
    ptr = flat_p.data_ptr()
    for name, p in params.items():
        if p.data_ptr() != ptr:
            raise ValueError(f"{name} is not where {optimizer}.init put it: "
                             "pass the parameters given to init")
        ptr += p.numel() * 4
    gs = [grads[name] for name in params]
    flat_g = flat_base(gs)
    if flat_g is None:
        flat_g = torch.cat([g.reshape(-1).float() for g in gs])
    return flat_g


class FusedSGD(SGD):
    """The fused optimizer: ``optim.SGD``'s hyperparameters and
    ``init``/``apply`` contract. ``init`` makes the parameters views of one
    flat buffer (see the module note); ``apply`` updates them in place."""

    def init(self, params: Dict[str, torch.Tensor]) -> SGDState:
        """Lay ``params`` out in one flat f32 buffer and rebind each to its
        view. Momentum buffers exist even at momentum 0, as in the JAX
        version (the kernel reads them)."""
        flat_p = flatten_params(params, "FusedSGD")
        flat_b = torch.zeros_like(flat_p)
        return SGDState(step=0, momentum=views_of(flat_b, params),
                        flat=(flat_p, flat_b))

    def apply(self, params: Dict[str, torch.Tensor], state: SGDState,
              grads: Dict[str, torch.Tensor]) -> SGDState:
        """One step, in place on the parameters and the momentum."""
        flat_p, flat_b = state.flat
        flat_g = flat_grads(params, flat_p, grads, "FusedSGD")
        lr = self.lr(state.step) if callable(self.lr) else self.lr
        fused_sgd_update(flat_p, flat_b, flat_g, lr, state.step == 0,
                         momentum=self.momentum, dampening=self.dampening,
                         weight_decay=self.weight_decay,
                         nesterov=self.nesterov)
        return state._replace(step=state.step + 1)
