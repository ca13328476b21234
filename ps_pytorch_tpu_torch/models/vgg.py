"""CIFAR VGG family, the JAX package's ``models/vgg.py``: the cfg table A /
B / D / E, conv (bias kept under BatchNorm) -> BatchNorm when ``batch_norm``
-> ReLU, a 2x2/2 max pool at ``"M"``, then flatten in NHWC order, Dropout
0.5, Dense 512, ReLU, Dropout 0.5, Dense 512, ReLU, Dense ``num_classes``,
f32 logits. Conv weights take He's fan-out init (``vgg.py:21``).

Submodule names are the flax names (``Conv_<k>`` for the k-th conv,
``BatchNorm_<j>``, ``Dense_0..2``, ``Dropout_0..1``), so weights map
mechanically (``models/convert.py``). Under ``conv_impl`` ``pallas`` or
``pallas_im2col`` every conv whose input has at least 8 channels runs the
hand-written kernel (``ops/conv3x3.py``) with its bias added after it,
exactly where the JAX package uses ``PallasConv3x3`` (``vgg.py:54``); the
3-channel input conv stays ``F.conv2d``.
"""

from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from ps_pytorch_tpu_torch.models.layers import (
    BatchNorm, Conv2d, Conv3x3, Dropout, Linear, he_normal_fan_out_,
)
from ps_pytorch_tpu_torch.models.resnet import pallas_variant

CFG = {
    "A": (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    "B": (64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512,
          "M"),
    "D": (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
          512, 512, 512, "M"),
    "E": (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
          512, 512, 512, 512, "M", 512, 512, 512, 512, "M"),
}


class VGG(nn.Module):
    def __init__(self, cfg: Sequence[Union[int, str]],
                 batch_norm: bool = False, num_classes: int = 10,
                 dtype: torch.dtype = torch.float32, conv_impl: str = "xla",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        # 32 px inputs (CIFAR, SVHN): Dense_0 takes the map the pools leave.
        layers, cin, hw, k = [], 3, 32, 0
        for v in cfg:
            if v == "M":
                layers.append("M")
                hw //= 2
                continue
            if conv_impl.startswith("pallas") and cin >= 8:
                conv = Conv3x3(cin, v, dtype, pallas_variant(conv_impl),
                               bias=True)
            else:
                conv = Conv2d(cin, v, 3, padding=1, bias=True, dtype=dtype)
            he_normal_fan_out_(conv.weight, generator)
            self.add_module(f"Conv_{k}", conv)
            layers.append(conv)
            if batch_norm:
                bn = BatchNorm(v, dtype)
                self.add_module(f"BatchNorm_{k}", bn)
                layers.append(bn)
            layers.append("R")
            cin, k = v, k + 1
        self.layers = layers
        self.Dropout_0 = Dropout(0.5)
        self.Dense_0 = Linear(cin * hw * hw, 512, dtype, generator)
        self.Dropout_1 = Dropout(0.5)
        self.Dense_1 = Linear(512, 512, dtype, generator)
        self.Dense_2 = Linear(512, num_classes, dtype, generator)

    def forward(self, x):
        # x: [B, H, W, C] NHWC; the permute is the channels_last view.
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        for layer in self.layers:
            if layer == "M":
                x = F.max_pool2d(x, 2, 2)
            elif layer == "R":
                x = F.relu(x)
            else:
                x = layer(x)
        x = x.permute(0, 2, 3, 1).flatten(1)      # NHWC order, vgg.py:68
        x = F.relu(self.Dense_0(self.Dropout_0(x)))
        x = F.relu(self.Dense_1(self.Dropout_1(x)))
        return self.Dense_2(x).float()


def _vgg(name: str, batch_norm: bool):
    def ctor(num_classes=10, dtype=torch.float32, conv_impl="xla",
             generator=None):
        return VGG(CFG[name], batch_norm, num_classes, dtype, conv_impl,
                   generator)
    return ctor


VGG11, VGG13, VGG16, VGG19 = (_vgg(c, False) for c in "ABDE")
VGG11_BN, VGG13_BN, VGG16_BN, VGG19_BN = (_vgg(c, True) for c in "ABDE")
