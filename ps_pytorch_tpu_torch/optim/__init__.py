"""Optimizers that consume gradients averaged elsewhere (functional
``init``/``apply``, as in the JAX package)."""

from ps_pytorch_tpu_torch.optim.adam import Adam, AdamState  # noqa: F401
from ps_pytorch_tpu_torch.optim.schedules import build_schedule  # noqa: F401
from ps_pytorch_tpu_torch.optim.sgd import SGD, SGDState  # noqa: F401


def build_optimizer(cfg):
    """Config -> optimizer: under ``fused_optimizer`` the Triton-kernel
    ``FusedSGD`` or ``FusedAdam``, else the plain ``SGD`` or ``Adam``."""
    lr = build_schedule(cfg)
    if cfg.optimizer == "sgd":
        if cfg.fused_optimizer:
            from ps_pytorch_tpu_torch.ops.fused_sgd import FusedSGD
            return FusedSGD(lr=lr, momentum=cfg.momentum,
                            weight_decay=cfg.weight_decay,
                            nesterov=cfg.nesterov)
        return SGD(lr=lr, momentum=cfg.momentum,
                   weight_decay=cfg.weight_decay, nesterov=cfg.nesterov)
    if cfg.optimizer == "adam":
        kw = dict(lr=lr, b1=cfg.adam_beta1, b2=cfg.adam_beta2,
                  eps=cfg.adam_eps, weight_decay=cfg.weight_decay,
                  amsgrad=cfg.amsgrad)
        if cfg.fused_optimizer:
            from ps_pytorch_tpu_torch.ops.fused_adam import FusedAdam
            return FusedAdam(**kw)
        return Adam(**kw)
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
