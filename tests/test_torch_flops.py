"""The port's FLOP count (ps_pytorch_tpu_torch/utils/flops.py) against the
JAX package's (ps_pytorch_tpu/utils/flops.py), on the CPU.

Every count is an exact integer, held to the JAX count of the xla /
full-attention route: the JAX package counts a Pallas kernel's program
once instead of once a grid program, so its pallas / flash counts are
lower than the model's work, and the port counts that work whatever route
it runs. The port counts on the ``meta`` device: nothing executes.
"""

import functools

import jax
import jax.numpy as jnp
import optax
import pytest

from ps_pytorch_tpu.models import build_model as jax_build_model
from ps_pytorch_tpu.models import transformer as jax_transformer
from ps_pytorch_tpu.utils import flops as jax_flops
from ps_pytorch_tpu_torch import config
from ps_pytorch_tpu_torch.data import datasets
from ps_pytorch_tpu_torch.telemetry import (
    aggregate_peak_flops, compute_mfu, derive_step_record,
)
from ps_pytorch_tpu_torch.utils import flops
from test_torch_train import two_torch_threads  # noqa: F401

# name -> (dataset, sample shape, classes); the ImageNet stems at 64 px.
CASES = {
    "LeNet": ("MNIST", (28, 28, 1), 10),
    "ResNet18": ("synthetic_cifar10", (32, 32, 3), 10),
    "VGG11": ("synthetic_cifar100", (32, 32, 3), 100),
    "VGG11_plain": ("synthetic_cifar100", (32, 32, 3), 100),
    "ResNet18_ImageNet": ("synthetic_imagenet", (64, 64, 3), 1000),
    "ResNet50_ImageNet": ("synthetic_imagenet", (64, 64, 3), 1000),
}
BATCH = 4
# The small LM: vocab 256, d 128, 2 layers, 4 heads, S 256, batch 2.
LM = dict(lm_vocab=256, lm_d_model=128, lm_layers=2, lm_heads=4,
          lm_seq_len=256)
LM_BATCH = 2
LM_FLOPS = 1_711_276_032

_JAX_COUNTS: dict = {}


class _ShapeInit:
    """A flax model whose ``init`` gives zeros of the variables' shapes
    (``jax.eval_shape``) instead of running the initializers op by op: the
    variables' values never enter the count, and the eager init is most
    of ``training_flops``'s time on the CPU."""

    def __init__(self, model):
        self.model = model

    def init(self, key, *args, **kw):
        shapes = jax.eval_shape(functools.partial(self.model.init, **kw),
                                key, *args)
        return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)

    def apply(self, *args, **kw):
        return self.model.apply(*args, **kw)


def _jax_count(name: str) -> int:
    """``training_flops`` of the JAX model built on the xla route."""
    if name not in _JAX_COUNTS:
        _, shape, classes = CASES[name]
        model = jax_build_model(name, classes, "float32", conv_impl="xla")
        _JAX_COUNTS[name] = jax_flops.training_flops(
            _ShapeInit(model), (BATCH,) + shape, classes)
    return _JAX_COUNTS[name]


def _cfg(name: str, **kw) -> config.TrainConfig:
    return config.TrainConfig(network=name, dataset=CASES[name][0],
                              eval_freq=0, **kw)


@pytest.fixture
def imagenet_64(monkeypatch):
    """synthetic_imagenet at 64 px (the stems' geometry, a few images)."""
    monkeypatch.setitem(datasets.DATASET_SHAPES, "synthetic_imagenet",
                        (64, 64, 3, 1000, 8))


@pytest.mark.parametrize("name", sorted(CASES))
def test_cnn_count_equals_jax_xla_route(name, imagenet_64):
    want = _jax_count(name)
    for impl in ("xla", "pallas", "pallas_im2col"):
        cfg = _cfg(name, conv_impl=impl)
        assert flops.training_flops(cfg, BATCH) == want, impl


@pytest.mark.parametrize("name", sorted(CASES))
def test_count_is_linear_in_batch(name, imagenet_64):
    cfg = _cfg(name)
    assert flops.training_flops(cfg, 2 * BATCH) == \
        2 * flops.training_flops(cfg, BATCH)


def test_lenet_counts_the_padded_input_gradient():
    """XLA's input gradient of LeNet's VALID 5x5 conv2 runs over the
    padded cotangent: 2 * (12*12*20) * 50 * 25 = 7.2 MFLOP an image, where
    the useful work (torch's own FlopCounterMode count) is 3.2."""
    from torch.utils.flop_counter import FlopCounterMode

    import torch
    import torch.nn.functional as F
    from ps_pytorch_tpu_torch.models import build_model

    model = build_model("LeNet", 10, "float32")
    x, y = torch.zeros(BATCH, 28, 28, 1), torch.zeros(BATCH,
                                                      dtype=torch.long)
    with FlopCounterMode(display=False) as torch_rule:
        F.cross_entropy(model(x), y).backward()
    ours = flops.training_flops(_cfg("LeNet"), BATCH)
    assert ours == 68_728_000 == _jax_count("LeNet")
    assert ours - torch_rule.get_total_flops() == BATCH * 4_000_000


def _jax_lm_count() -> int:
    model = jax_transformer.TransformerLM(
        vocab_size=LM["lm_vocab"], d_model=LM["lm_d_model"],
        n_layers=LM["lm_layers"], n_heads=LM["lm_heads"],
        max_seq_len=LM["lm_seq_len"], attention_impl="full")
    tokens = jnp.zeros((LM_BATCH, LM["lm_seq_len"]), jnp.int32)
    params = jax.eval_shape(model.init, jax.random.key(0), tokens)["params"]

    def loss(p, t):
        logits = model.apply({"params": p}, t)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.roll(t, -1, axis=1)).mean()

    return jax_flops.forward_flops(jax.value_and_grad(loss), params, tokens)


def test_lm_count_equals_jax_full_attention():
    assert _jax_lm_count() == LM_FLOPS
    for attention in ("full", "flash"):
        cfg = config.TrainConfig(network="TransformerLM", eval_freq=0,
                                 batch_size=LM_BATCH, lm_attention=attention,
                                 **LM)
        assert flops.training_flops(cfg) == LM_FLOPS, attention
        assert flops.training_flops(cfg, 2 * LM_BATCH) == 2 * LM_FLOPS


def test_counter_rules_on_single_ops():
    """A matmul is 2mkn; a stride-2 conv's input gradient is divided by
    the stride's taps; an input that takes no gradient has none."""
    import torch
    import torch.nn.functional as F

    with torch.device("meta"):
        a = torch.zeros(8, 16, requires_grad=True)
        b = torch.zeros(16, 32)
        x = torch.zeros(2, 4, 8, 8, requires_grad=True)
        w = torch.zeros(6, 4, 3, 3, requires_grad=True)
    with flops.FlopCounter() as c:
        a @ b
    assert c.flops == 2 * 8 * 16 * 32
    fwd = 2 * (2 * 6 * 4 * 4) * (4 * 9)       # out [2, 6, 4, 4]
    with flops.FlopCounter() as c:
        F.conv2d(x, w, stride=2, padding=1).sum().backward()
    assert c.flops == fwd + fwd + 2 * (2 * 4 * 8 * 8) * 6 * 9 // 4
    with flops.FlopCounter() as c:
        F.conv2d(x.detach(), w, stride=2, padding=1).sum().backward()
    assert c.flops == 2 * fwd


@pytest.mark.parametrize("name,peak", [
    ("NVIDIA H100 80GB HBM3", 989e12), ("NVIDIA H100 SXM5 80GB", 989e12),
    ("cpu", None), ("", None), (None, None), ("NVIDIA A100-SXM4-80GB", None),
])
def test_peak_table(name, peak):
    assert flops.peak_flops_bf16(name) == peak


def test_no_peak_off_cuda():
    assert aggregate_peak_flops("cpu") is None


def test_compute_mfu_hand_arithmetic():
    # 100 GFLOP a step in 0.25 s on 4 cards of 200 GFLOP/s peak: 0.5.
    assert compute_mfu(100_000_000_000, 0.25, 200e9, 4) == pytest.approx(0.5)
    assert compute_mfu(None, 0.25, 200e9, 4) is None
    assert compute_mfu(100, 0.0, 200e9, 4) is None
    assert compute_mfu(100, 0.25, None, 4) is None
    assert compute_mfu(-1, 0.25, 200e9, 4) is None


def test_step_record_mfu_is_rounded_count_over_time_and_peak():
    rec = derive_step_record(step_time_s=0.04, data_time_s=0.001,
                             examples=256, flops_per_step=852_223_328_256,
                             peak_flops_per_chip=989e12)
    assert rec["mfu"] == round(852_223_328_256 / (0.04 * 989e12), 6)
    assert derive_step_record(step_time_s=0.04, examples=256,
                              flops_per_step=852_223_328_256)["mfu"] is None
