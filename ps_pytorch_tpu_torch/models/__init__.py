"""Model zoo of the port: LeNet, the CIFAR ResNets, the ImageNet-stem
ResNet18 and ResNet50, and VGG11-19 with and without BatchNorm, with the JAX
package's names (``ps_pytorch_tpu/models/__init__.py``: ``"VGG11"`` is
VGG11 with BatchNorm, ``"VGG11_plain"`` without), layouts (NHWC input) and
numerics."""

import torch

from ps_pytorch_tpu_torch.models.lenet import LeNet
from ps_pytorch_tpu_torch.models.resnet import (
    ResNet18, ResNet34, ResNet50, ResNet101, ResNet152,
    ResNet18_ImageNet, ResNet50_ImageNet,
)
from ps_pytorch_tpu_torch.models.vgg import (
    VGG11, VGG13, VGG16, VGG19, VGG11_BN, VGG13_BN, VGG16_BN, VGG19_BN,
)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}

_REGISTRY = {
    "LeNet": LeNet,
    "ResNet18": ResNet18,
    "ResNet34": ResNet34,
    "ResNet50": ResNet50,
    "ResNet101": ResNet101,
    "ResNet152": ResNet152,
    "VGG11": VGG11_BN,
    "VGG13": VGG13_BN,
    "VGG16": VGG16_BN,
    "VGG19": VGG19_BN,
    "ResNet18_ImageNet": ResNet18_ImageNet,
    "ResNet50_ImageNet": ResNet50_ImageNet,
    "VGG11_plain": VGG11,
    "VGG13_plain": VGG13,
    "VGG16_plain": VGG16,
    "VGG19_plain": VGG19,
}


def build_model(model_name: str, num_classes: int = 10,
                compute_dtype="float32", conv_impl: str = "xla",
                seed: int = 0) -> torch.nn.Module:
    """Name -> module on the CPU, its weights drawn from a generator seeded
    with ``seed`` (flax's initializers, not flax's random bits). ``pallas``
    / ``pallas_im2col`` send the stride-1 3x3 convs of the ResNets and the
    VGGs through the hand-written kernel; LeNet ignores ``conv_impl``, as
    in the JAX package."""
    if isinstance(compute_dtype, str):
        compute_dtype = DTYPES[compute_dtype]
    if model_name not in _REGISTRY:
        raise ValueError(f"unknown model {model_name!r}; "
                         f"choose from {sorted(_REGISTRY)}")
    if conv_impl not in ("xla", "pallas", "pallas_im2col"):
        raise ValueError(f"unknown conv_impl {conv_impl!r}")
    gen = torch.Generator().manual_seed(seed)
    if model_name == "LeNet":
        return LeNet(num_classes, compute_dtype, gen)
    return _REGISTRY[model_name](num_classes, compute_dtype, conv_impl, gen)


def model_names():
    return sorted(_REGISTRY)
