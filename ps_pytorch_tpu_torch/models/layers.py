"""Layers with the JAX package's numerics: f32 parameters cast to the
compute type at each call (``resnet.py:44, 154``), flax's BatchNorm
statistics, flax's initializers, and flax's Dropout arithmetic.

Activations are NCHW tensors in channels_last memory, so ``permute(0, 2,
3, 1)`` is a free NHWC view for the conv kernel.
"""

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ps_pytorch_tpu_torch.ops.conv3x3 import Conv3x3Function


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator]) -> None:
    """flax's default kernel init: truncated normal (2 std) with variance
    1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / .87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                              generator=generator)


def he_normal_fan_out_(w: torch.Tensor,
                       generator: Optional[torch.Generator]) -> None:
    """The VGG convs' init, flax's ``variance_scaling(2.0, "fan_out",
    "normal")`` (``vgg.py:21``): an untruncated normal with variance
    2 / fan_out, fan_out = kh * kw * Co of the OIHW weight."""
    fan_out = w.shape[0] * w.shape[2] * w.shape[3]
    with torch.no_grad():
        w.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)


class Conv2d(nn.Module):
    """``flax.linen.Conv`` through ``F.conv2d``: OIHW weight, optional bias,
    explicit symmetric padding."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: int = 0, bias: bool = False,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stride, self.padding, self.dtype = stride, padding, dtype
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        lecun_normal_(self.weight, cin * k * k, generator)
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype), b,
                        self.stride, self.padding)


class Conv3x3(nn.Module):
    """3x3 stride-1 SAME conv through the hand-written kernel
    (``ops/conv3x3.py``): the counterpart of ``resnet.py:PallasConv3x3``.
    The weight stays OIHW so that ``xla`` and ``pallas`` state_dicts are
    interchangeable; the call permutes it to ``[3,3,C,Co]``. With ``bias``
    (VGG) the zero-initialised bias is added after the kernel, in the
    compute type, as ``PallasConv3x3`` adds it: the kernel rounds once and
    the add rounds again."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype = torch.float32,
                 variant: str = "taps9",
                 generator: Optional[torch.Generator] = None,
                 bias: bool = False):
        super().__init__()
        self.dtype, self.variant = dtype, variant
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3))
        lecun_normal_(self.weight, cin * 9, generator)
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x):
        w = self.weight.to(self.dtype).permute(2, 3, 1, 0).contiguous()
        xh = x.to(self.dtype).permute(0, 2, 3, 1).contiguous()
        out = Conv3x3Function.apply(xh, w, self.variant).permute(0, 3, 1, 2)
        if self.bias is not None:
            out = out + self.bias.to(self.dtype)[:, None, None]
        return out


class Linear(nn.Module):
    """``flax.linen.Dense``: inputs, kernel and bias (``use_bias``) cast to
    the compute type."""

    def __init__(self, fin: int, fout: int, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None,
                 bias: bool = True):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(fout, fin))
        lecun_normal_(self.weight, fin, generator)
        self.bias = nn.Parameter(torch.zeros(fout)) if bias else None

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), b)


class BatchNorm(nn.Module):
    """``flax.linen.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the channel
    axis. Statistics in f32 with flax's fast variance E[x^2] - E[x]^2
    (biased, clipped at 0); the running update is
    ``ra = momentum * ra + (1 - momentum) * batch_stat``, with the biased
    variance, which ``nn.BatchNorm2d`` does not do."""

    def __init__(self, num_features: int, dtype: torch.dtype = torch.float32,
                 momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.dtype, self.momentum, self.eps = dtype, momentum, eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        xf = x.float()
        if self.training:
            mean = xf.mean((0, 2, 3))
            var = ((xf * xf).mean((0, 2, 3)) - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                self.running_mean.copy_(self.momentum * self.running_mean
                                        + (1 - self.momentum) * mean)
                self.running_var.copy_(self.momentum * self.running_var
                                       + (1 - self.momentum) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]
        return y.to(self.dtype)


class Dropout(nn.Module):
    """``flax.linen.Dropout(rate)`` with flax's arithmetic: keep where a
    uniform draw is below ``1 - rate``, output ``where(keep, x / keep_prob,
    0)``; the identity in eval mode. The draws come from ``generator``, a
    ``torch.Generator`` on the activations' device that the train step
    seeds before each forward (``parallel/dp.py:DropoutDraws``); there is
    no global stream to fall back on. ``mask_fn(x) -> keep`` (a bool
    tensor of x's shape) replaces the draws, so that a test can inject the
    reference's masks."""

    def __init__(self, rate: float,
                 mask_fn: Optional[Callable[[torch.Tensor], torch.Tensor]]
                 = None):
        super().__init__()
        self.rate = rate
        self.mask_fn = mask_fn
        self.generator: Optional[torch.Generator] = None

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        keep_prob = 1.0 - self.rate
        if self.mask_fn is not None:
            keep = self.mask_fn(x).to(device=x.device, dtype=torch.bool)
            if keep.shape != x.shape:
                raise ValueError(f"mask_fn gave a mask of shape "
                                 f"{tuple(keep.shape)} for {tuple(x.shape)}")
        elif self.generator is None:
            raise RuntimeError("Dropout in train mode needs its generator "
                               "(seeded by the train step) or a mask_fn")
        else:
            keep = torch.rand(x.shape, generator=self.generator,
                              device=x.device) < keep_prob
        return torch.where(keep, x / keep_prob, torch.zeros_like(x))
