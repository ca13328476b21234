"""ResNets, the JAX package's ``models/resnet.py``: the CIFAR stem (3x3
stride-1, no maxpool) or, with ``imagenet_stem``, the ImageNet one (7x7/2
conv, BatchNorm, ReLU, 3x3/2 max pool with padding 1); stages
[64,128,256,512] with strides [1,2,2,2], projection shortcut where the
shape changes, then a 4x4 average pool (CIFAR) or a global mean over H and
W (ImageNet), linear head.

Submodule names are the flax names (``conv1``, ``bn1``, ``BasicBlock_<i>``
with ``Conv_<k>``/``BatchNorm_<k>``, ``linear``), so weights map
mechanically (``models/convert.py``). Under ``conv_impl`` ``pallas`` or
``pallas_im2col`` the stride-1 3x3 convs run the hand-written kernel
(``ops/conv3x3.py``); the stem, the strided 3x3s and the 1x1 projections
stay ``F.conv2d``, as the JAX package leaves them to XLA.
"""

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ps_pytorch_tpu_torch.models.layers import (
    BatchNorm, Conv2d, Conv3x3, Linear,
)


def pallas_variant(conv_impl: str) -> str:
    """``pallas`` -> taps9, ``pallas_im2col`` -> im2col."""
    return "im2col" if conv_impl == "pallas_im2col" else "taps9"


def _conv3(cin, cout, dtype, conv_impl, generator):
    """The stride-1 3x3 conv: the kernel under a ``pallas*`` conv_impl."""
    if conv_impl.startswith("pallas"):
        return Conv3x3(cin, cout, dtype, pallas_variant(conv_impl), generator)
    return Conv2d(cin, cout, 3, padding=1, dtype=dtype, generator=generator)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32, conv_impl: str = "xla",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        if stride == 1:
            self.Conv_0 = _conv3(cin, planes, dtype, conv_impl, g)
        else:
            self.Conv_0 = Conv2d(cin, planes, 3, stride, 1, dtype=dtype,
                                 generator=g)
        self.BatchNorm_0 = BatchNorm(planes, dtype)
        self.Conv_1 = _conv3(planes, planes, dtype, conv_impl, g)
        self.BatchNorm_1 = BatchNorm(planes, dtype)
        self.shortcut = stride != 1 or cin != planes * self.expansion
        if self.shortcut:
            self.Conv_2 = Conv2d(cin, planes * self.expansion, 1, stride,
                                 dtype=dtype, generator=g)
            self.BatchNorm_2 = BatchNorm(planes * self.expansion, dtype)

    def forward(self, x):
        out = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        out = self.BatchNorm_1(self.Conv_1(out))
        if self.shortcut:
            x = self.BatchNorm_2(self.Conv_2(x))
        return F.relu(out + x)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32, conv_impl: str = "xla",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        out = planes * self.expansion
        self.Conv_0 = Conv2d(cin, planes, 1, dtype=dtype, generator=g)
        self.BatchNorm_0 = BatchNorm(planes, dtype)
        if stride == 1:
            self.Conv_1 = _conv3(planes, planes, dtype, conv_impl, g)
        else:
            self.Conv_1 = Conv2d(planes, planes, 3, stride, 1, dtype=dtype,
                                 generator=g)
        self.BatchNorm_1 = BatchNorm(planes, dtype)
        self.Conv_2 = Conv2d(planes, out, 1, dtype=dtype, generator=g)
        self.BatchNorm_2 = BatchNorm(out, dtype)
        self.shortcut = stride != 1 or cin != out
        if self.shortcut:
            self.Conv_3 = Conv2d(cin, out, 1, stride, dtype=dtype, generator=g)
            self.BatchNorm_3 = BatchNorm(out, dtype)

    def forward(self, x):
        out = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        out = F.relu(self.BatchNorm_1(self.Conv_1(out)))
        out = self.BatchNorm_2(self.Conv_2(out))
        if self.shortcut:
            x = self.BatchNorm_3(self.Conv_3(x))
        return F.relu(out + x)


class ResNet(nn.Module):
    def __init__(self, block, num_blocks: Sequence[int], num_classes: int = 10,
                 dtype: torch.dtype = torch.float32, conv_impl: str = "xla",
                 generator: Optional[torch.Generator] = None,
                 imagenet_stem: bool = False):
        super().__init__()
        self.dtype = dtype
        self.imagenet_stem = imagenet_stem
        if imagenet_stem:
            self.conv1 = Conv2d(3, 64, 7, 2, 3, dtype=dtype,
                                generator=generator)
        else:
            self.conv1 = Conv2d(3, 64, 3, padding=1, dtype=dtype,
                                generator=generator)
        self.bn1 = BatchNorm(64, dtype)
        blocks, cin = [], 64
        for planes, n, stride in zip((64, 128, 256, 512), num_blocks,
                                     (1, 2, 2, 2)):
            for i in range(n):
                blocks.append(block(cin, planes, stride if i == 0 else 1,
                                    dtype, conv_impl, generator))
                cin = planes * block.expansion
        for i, b in enumerate(blocks):
            self.add_module(f"{block.__name__}_{i}", b)
        self.blocks = blocks
        self.linear = Linear(512 * block.expansion, num_classes, dtype,
                             generator)

    def forward(self, x):
        # x: [B, H, W, 3] NHWC; the permute is the channels_last view.
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        x = F.relu(self.bn1(self.conv1(x)))
        if self.imagenet_stem:
            # Padded cells are -inf, as flax pads: they never win the max.
            x = F.max_pool2d(x, 3, 2, 1)
        for b in self.blocks:
            x = b(x)
        if self.imagenet_stem:
            x = x.mean((2, 3))                   # global average pool
        else:
            x = F.avg_pool2d(x, 4).flatten(1)
        return self.linear(x).float()


def ResNet18(num_classes=10, dtype=torch.float32, conv_impl="xla",
             generator=None):
    return ResNet(BasicBlock, (2, 2, 2, 2), num_classes, dtype, conv_impl,
                  generator)


def ResNet34(num_classes=10, dtype=torch.float32, conv_impl="xla",
             generator=None):
    return ResNet(BasicBlock, (3, 4, 6, 3), num_classes, dtype, conv_impl,
                  generator)


def ResNet50(num_classes=10, dtype=torch.float32, conv_impl="xla",
             generator=None):
    return ResNet(Bottleneck, (3, 4, 6, 3), num_classes, dtype, conv_impl,
                  generator)


def ResNet101(num_classes=10, dtype=torch.float32, conv_impl="xla",
              generator=None):
    return ResNet(Bottleneck, (3, 4, 23, 3), num_classes, dtype, conv_impl,
                  generator)


def ResNet152(num_classes=10, dtype=torch.float32, conv_impl="xla",
              generator=None):
    return ResNet(Bottleneck, (3, 8, 36, 3), num_classes, dtype, conv_impl,
                  generator)


def ResNet18_ImageNet(num_classes=1000, dtype=torch.float32, conv_impl="xla",
                      generator=None):
    return ResNet(BasicBlock, (2, 2, 2, 2), num_classes, dtype, conv_impl,
                  generator, imagenet_stem=True)


def ResNet50_ImageNet(num_classes=1000, dtype=torch.float32, conv_impl="xla",
                      generator=None):
    return ResNet(Bottleneck, (3, 4, 6, 3), num_classes, dtype, conv_impl,
                  generator, imagenet_stem=True)
